"""Paced fakes of SDR libraries, one file a library, found by the mix's
``sdr`` (radiobench/drive.py)."""
