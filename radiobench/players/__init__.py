"""Players of traffic mixes, one file a ``kind``, found by the kind's
name (radiobench/drive.py)."""
