"""Decoded messages as a judged output (CPU; ~30 s).

    python -m pytest radiobench/tests -q

A toy message cell of the tests' own (``toy/``: its configuration, graph,
reference, traffic mix, player and limits, named by ``toy/bench.json``
and not by BENCHMARK.json) runs through ``harness.run_cell``: four pager
channels on a ``BankSource`` into the program's ``POCSAGReceiver(1200)``
and the benchmark's ``MessageSink``, the receiver's data filter into the
sink's soft tap.  A sound run reads ``correct``; each planted fault, under
the timed path in the program's blocks or its source, reads false, and so
does the control (the reference one precision down in the program's
place).  The comparison itself (radiobench/judge.py ``messages``) is also
held to hand-made windows.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

TOY = Path(__file__).resolve().parent / "toy"
REPO = TOY.parents[2]
sys.path.insert(0, str(REPO))

from radiobench import control, harness, judge, window  # noqa: E402

torch.set_num_threads(1)
BENCH = harness.benchmark(TOY / "bench.json")
LIMITS = harness.load_json(TOY / "workloads" / "pocsag.toy.json")["limits"]
CELL = "pocsag.toy"
ROWS = 4
SEED = 3000000051


def _run(seconds=1.0, seed=SEED):
    return harness.run_cell(CELL, seed, seconds, False, device="cpu",
                            bench=BENCH)


def _numbers(res):
    return {k: c["value"] for k, c in res["checks"].items()}


def test_toy_cell_runs_correct():
    res, rec = _run()
    assert res["correct"], (res, rec)
    got = _numbers(res)
    assert got["msg_missed"] == 0.0 and got["msg_wrong"] == 0.0
    assert 0 < got["soft_gap"] < LIMITS["soft_gap"]
    assert got["compared_messages"] >= 1 and got["compared_chunks"] > 1
    assert list(res["checks"]) == ["msg_missed", "msg_wrong", "soft_gap",
                                   "compared_messages", "compared_chunks"]
    assert rec["messages_emitted"] >= rec["messages_expected"] >= \
        ROWS * got["compared_messages"]
    assert set(res["metrics"]) == {"bank_msps", "setup_s"}


def test_window_counts_chunks_not_rows(monkeypatch):
    """The sink takes a call a row a chunk; the window one a chunk, so
    ``window_chunks`` and ``bank_msps`` count chunks as for audio."""
    calls = {"sink": 0, "window": 0}
    sink_process, on_chunk = window.MessageSink.process, \
        window.Window.on_chunk

    def counted_process(self, x):
        calls["sink"] += 1
        return sink_process(self, x)

    def counted_chunk(self, xs, messages=None):
        calls["window"] += 1
        return on_chunk(self, xs, messages)
    monkeypatch.setattr(window.MessageSink, "process", counted_process)
    monkeypatch.setattr(window.Window, "on_chunk", counted_chunk)
    res, rec = _run()
    assert res["correct"], (res, rec)
    assert calls["sink"] == ROWS * calls["window"]
    n = rec["window_chunks"]
    assert 0 < n < calls["window"] and sum(rec["chunks_by_second"]) == n
    assert res["attempted"] == ROWS * n
    assert res["metrics"]["bank_msps"]["value"] == pytest.approx(
        n * rec["chunk_in"] * ROWS / 1.0 / 1e6)


def test_sink_calls_not_in_whole_rows_are_an_error(monkeypatch):
    """A runtime that handed the sink a chunk's rows in one call (or
    dropped a row's call) is the run's error."""
    from luaradio_tpu_torch.core import runtime
    banked = runtime.Runner._run_host_banked

    def joined(self, b, values, nvalid):
        if isinstance(b, window.MessageSink):
            src = self.graph.edges[runtime.PortRef(b, 0)]
            v = values[f"{self.bid[id(src.block)]}.{src.index}"]
            return b.process([m for row in v.rows for m in row])
        return banked(self, b, values, nvalid)
    monkeypatch.setattr(runtime.Runner, "_run_host_banked", joined)
    res, rec = _run()
    assert not res["correct"]
    assert "not whole rows" in rec["error"]


def _per_row(fn):
    """A fault planted in the program's POCSAG decoder: ``fn(row, chunk,
    messages)`` -> messages, in each row's own decoder (the runtime clones
    it a row, and calls the clones once a chunk in row order)."""
    from luaradio_tpu_torch.blocks.protocol.pocsag import POCSAGDecoderBlock
    orig = POCSAGDecoderBlock.process
    rows, chunks = {}, {}

    def planted(self, frames):
        out = orig(self, frames)
        row = rows.setdefault(id(self), len(rows))
        c = chunks[row] = chunks.get(row, -1) + 1
        return fn(row, c, out)
    return POCSAGDecoderBlock, planted


def _once(row, after, change):
    """``change(messages)`` on the first chunk of ``row`` from chunk
    ``after`` on (inside the window) that carries a message."""
    done = []

    def fn(r, c, out):
        if r == row and c >= after and out and not done:
            done.append(c)
            return change(out)
        return out
    return fn


def _altered(out):
    m = out[0]
    text = m.alphanumeric
    m.alphanumeric = text[:-1] + chr(ord(text[-1]) ^ 1)
    return out


def _early_skip():
    """The stream skips ahead once, inside the window, by two chunks of
    input (more than the reference's ``lag``): every later page comes out
    before its last bit is due."""
    from luaradio_tpu_torch.blocks.sources.bank import BankSource
    orig = BankSource.read_wire_into
    calls = {"n": 0}

    def skipping(self, out):
        calls["n"] += 1
        if calls["n"] == 16:
            for _ in range(2):
                orig(self, out.copy())
        return orig(self, out)
    return BankSource, "read_wire_into", skipping


def _swapped_rows():
    """Rows 0 and 1 of the bank's input exchanged where the source
    produces them: each row decodes the other's pages."""
    from luaradio_tpu_torch.blocks.sources.bank import BankSource
    orig = BankSource.read_wire_into

    def swapped(self, out):
        n = orig(self, out)
        out[[0, 1]] = out[[1, 0]]
        return n
    return BankSource, "read_wire_into", swapped


def _data_filter_gain():
    """The receiver's data filter designed a thousandth too loud: every
    bit is still sliced as sent, so only the soft samples show it."""
    import luaradio_tpu_torch as lr
    orig = lr.LowpassFilterBlock.design_taps

    def louder(self):
        return orig(self) * (1 + 1e-3)
    return lr.LowpassFilterBlock, "design_taps", louder


FAULTS = {
    "one_page_dropped": lambda: _per_row(_once(0, 9, lambda out: out[1:])),
    "one_character_altered": lambda: _per_row(_once(1, 9, _altered)),
    "two_rows_swapped": _swapped_rows,
    "silent_row": lambda: _per_row(
        lambda r, c, out: [] if r == 2 else out),
    "page_repeated": lambda: _per_row(
        _once(3, 9, lambda out: out[:1] + out)),
    "page_before_its_at": _early_skip,
    "data_filter_gain": _data_filter_gain,
}

#: what each fault has to move: the numbers that read above their limit
MOVES = {
    "one_page_dropped": {"msg_missed"},
    "one_character_altered": {"msg_missed", "msg_wrong"},
    "two_rows_swapped": {"msg_missed", "msg_wrong", "soft_gap"},
    "silent_row": {"msg_missed"},
    "page_repeated": {"msg_wrong"},
    "page_before_its_at": {"msg_missed", "msg_wrong", "soft_gap"},
    "data_filter_gain": {"soft_gap"},
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_message_fault_reads_false(fault):
    planted = FAULTS[fault]()
    cls, attr, fn = planted if len(planted) == 3 else (
        planted[0], "process", planted[1])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, attr, fn)
        res, rec = _run()
    assert "error" not in rec, rec
    assert not res["correct"], (res, rec)
    got = _numbers(res)
    over = {k for k in LIMITS if got[k] > LIMITS[k]}
    assert over == MOVES[fault], (got, rec)
    if fault == "silent_row":
        assert got["msg_missed"] == 1.0


def test_control_reads_false():
    """The control of a message cell, the reference one precision down in
    the program's place, goes through the same comparison and reads
    ``correct`` false: its messages are every one and none wrong (the
    eye is open at either precision), its soft samples lie above the
    limit."""
    for seed in (SEED, SEED + 7919, 2**31 + 12345):
        got = control.control_numbers(CELL, seed, "cpu", bench=BENCH)
        assert got["correct"] is False, got
        ctl = got["control"]
        assert ctl["msg_missed"] == 0.0 and ctl["msg_wrong"] == 0.0
        assert ctl["soft_gap"] > 5 * LIMITS["soft_gap"]
        assert ctl["compared_messages"] >= 1
        assert got["limits"] == {**LIMITS, "compared_messages": 1}


def test_control_cli_prints_numbers_beside_limits(capsys):
    assert control.main(["--workload", CELL, "--seeds", str(SEED),
                         "--device", "cpu",
                         "--bench", str(TOY / "bench.json")]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("msg_missed", "msg_wrong", "soft_gap", "compared_messages"):
        assert k in line["control"] and k in line["limits"]
    assert line["correct"] is False


# -- the comparison on hand-made windows ------------------------------------

CHUNK, LAG, PERIOD = 100, 30, 1000
#: one row: two messages a period, decoded from zero state over two
REF = [[(150, "a"), (640, "b"), (1150, "a"), (1640, "b")]]


def _kept(records, first=3, last=24):
    kept = {c: [] for c in range(first, last + 1)}
    for c, text in records:
        kept[c].append((c, 0, text))
    return kept


def _sound(first=3, last=24):
    """Each message emitted in the chunk its last bit enters, over
    chunks first .. last."""
    out = []
    for k in range(3):
        for at, t in ((150, "a"), (640, "b")):
            c = (at + k * PERIOD) // CHUNK
            if first <= c <= last:
                out.append((c, t))
    return out


def test_judge_holds_a_sound_window():
    got, extra = judge.messages(_kept(_sound()), REF, CHUNK, LAG, PERIOD)
    assert got == {"msg_missed": 0.0, "msg_wrong": 0.0,
                   "compared_messages": 4}
    assert extra["messages_edge"] == 0


@pytest.mark.parametrize("records,missed,wrong", [
    # late: chunk 8 starts past 640 + lag
    ([(8, "b"), (11, "a"), (16, "b"), (21, "a")], 0.25, 0.25),
    # early: emitted in chunk 5, whose end lies before 640
    ([(5, "b"), (11, "a"), (16, "b"), (21, "a")], 0.25, 0.25),
    # out of order: b after the next a is missed there, and wrong after
    ([(11, "a"), (11, "b"), (16, "b"), (21, "a")], 0.25, 0.25),
])
def test_judge_holds_place_and_order(records, missed, wrong):
    got, _ = judge.messages(_kept(records), REF, CHUNK, LAG, PERIOD)
    assert got["msg_missed"] == missed and got["msg_wrong"] == wrong


def test_judge_edges_are_neither_expected_nor_wrong():
    """A message whose last bit came before the window (x at 290), emitted
    in its first chunk within ``lag``, and one due after the window's end
    less ``lag`` (y at 2485) that came in time, are neither expected nor
    wrong; the latter, had it not come, is not missed."""
    ref = [[(290, "x"), (640, "b"), (1150, "a"), (1485, "y"), (1640, "b")]]
    records = [(3, "x"), (6, "b"), (11, "a"), (14, "y"), (16, "b"),
               (21, "a"), (24, "y")]
    got, extra = judge.messages(_kept(records), ref, CHUNK, LAG, PERIOD)
    assert got["msg_missed"] == 0.0 and got["msg_wrong"] == 0.0
    assert extra["messages_edge"] == 2
    got, _ = judge.messages(_kept(records[:-1]), ref, CHUNK, LAG, PERIOD)
    assert got["msg_missed"] == 0.0 and got["msg_wrong"] == 0.0


def test_judge_unrolls_the_second_period():
    """Past the first period the reference's second repeats: a window far
    into the stream is judged against it."""
    kept = _kept([(c, t) for c, t in (
        (41, "a"), (46, "b"), (51, "a"), (56, "b"))], first=40, last=59)
    got, _ = judge.messages(kept, REF, CHUNK, LAG, PERIOD)
    assert got == {"msg_missed": 0.0, "msg_wrong": 0.0,
                   "compared_messages": 4}


def test_judge_counts_the_fewest_expected_of_any_row():
    """A row with no message due in the window leaves that row unjudged:
    ``compared_messages`` reads the fewest of any row, and the run is not
    correct below 1."""
    ref = REF + [[(2950, "z")]]         # row 1's only page lies past it
    got, _ = judge.messages(_kept(_sound()), ref, CHUNK, LAG, PERIOD)
    assert got["compared_messages"] == 0
    checks = {k: {"value": v, "limit": harness.AT_LEAST.get(k, 0.0)}
              for k, v in got.items()}
    assert not harness.verdict(checks)
    got, _ = judge.messages(_kept(_sound()), REF, CHUNK, LAG, PERIOD)
    checks = {k: {"value": v, "limit": harness.AT_LEAST.get(k, 0.0)}
              for k, v in got.items()}
    assert got["compared_messages"] == 4 and harness.verdict(checks)


def test_judge_reads_a_silent_row_and_a_stray_row():
    ref = REF + REF
    kept = _kept(_sound())
    got, _ = judge.messages(kept, ref, CHUNK, LAG, PERIOD)
    assert got["msg_missed"] == 1.0 and got["msg_wrong"] == 0.0
    kept[5].append((5, 7, "a"))         # a row the reference lacks
    got, _ = judge.messages(kept, ref, CHUNK, LAG, PERIOD)
    assert got["msg_wrong"] == 1.0


def test_toy_uses_only_files_the_readme_names():
    """A message cell is files and entries only: the toy's files are the
    kinds radiobench/README.md names for a configuration, its reference,
    a traffic mix and its player, and a cell's limits, under the names
    its entry gives."""
    w = BENCH["workloads"][0]
    mix = harness.load_json(TOY / "traffic" / f"{w['traffic']}.json")
    named = {"bench.json", f"configs/{w['config']}.json",
             f"configs/{w['config']}.py", f"reference/{w['config']}.py",
             f"traffic/{w['traffic']}.json", f"players/{mix['kind']}.py",
             f"workloads/{w['name']}.json"}
    have = {p.relative_to(TOY).as_posix() for p in TOY.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}
    assert have == named
    readme = (REPO / "radiobench" / "README.md").read_text()
    for part in ('"output": "messages"', "messages(raw, cfg, precision",
                 "soft(raw, cfg, precision", '"lag"', '"soft_ds"',
                 "MessageSink", "sink.soft", "players/<kind>.py"):
        assert part in readme
    assert harness.load_json(TOY / "configs" / f"{w['config']}.json")[
        "output"] == "messages"
