"""The digital applications through the port's cli.main(..., device="cpu")
against the JAX package's cli.main on the same iqfile: rx_rds, rx_pocsag,
rx_ax25 and rx_ert (--protocols=scm).  The ``json`` output's lines must
be equal, and decode what the capture carries; the ``print`` output runs
and prints one line a packet.

Each capture holds the station at the tuned frequency (the iqfile
input's tune offset is 0), at a rate whose tuner decimation lands on the
receiver's IF: RDS at 551 250 S/s (decimation 2, IF 275 625 S/s, as on
a 1 102 500 S/s input), POCSAG at 38 400 (3, IF 12 800), AX.25 at
48 000 (4, IF 12 000), ERT at 2 359 296 S/s (tests/core/
test_receivers.py make_scm_iq's rate).
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from luaradio_tpu.cli import main as jax_main  # noqa: E402
from luaradio_tpu_torch.applications import APPLICATIONS  # noqa: E402
from luaradio_tpu_torch.cli import main as port_main  # noqa: E402
from tests.core.test_receivers import (make_ax25_iq,  # noqa: E402
                                       make_pocsag_iq, make_scm_iq)
from tests.test_torch_receivers import rds_noise_capture  # noqa: E402

RDS_RATE = 551250.0


def _capture(tmp_path, app):
    """(path, rate, the app's arguments, a check of the decoded JSON)."""
    if app == "rx_rds":
        iq, groups = rds_noise_capture(RDS_RATE, noise_s=0.1, n_groups=6,
                                       seed=21)

        def check(recs):
            raw = [tuple(r["data"]["frame"]) for r in recs
                   if r["data"].get("type") == "raw"]
            assert len([g for g in groups if g in raw]) >= 4, (groups, raw)
        rate, args = RDS_RATE, ["0"]
    elif app == "rx_pocsag":
        iq, rate, baud, address, func, text = make_pocsag_iq()

        def check(recs):
            assert (recs[0]["address"], recs[0]["func"],
                    recs[0]["alphanumeric"]) == (address, func, text)
        args = ["0", "--baudrate", str(baud)]
    elif app == "rx_ax25":
        iq, rate = make_ax25_iq()

        def check(recs):
            assert recs[0]["addresses"][0]["callsign"] == "NOCALL"
            assert recs[0]["payload"] == "hello from tpu radio"
        args = ["0"]
    else:
        iq, rate, ert_id, consumption = make_scm_iq()

        def check(recs):
            assert (recs[0]["ert_id"], recs[0]["consumption"]) == (
                ert_id, consumption)
        args = ["--protocols=scm"]
    path = str(tmp_path / f"{app}.iq")
    iq.astype(np.complex64).view(np.float32).tofile(path)
    return path, rate, args, check


@pytest.mark.parametrize("app", ["rx_rds", "rx_pocsag", "rx_ax25",
                                 "rx_ert"])
def test_digital_cli_json_matches_jax(tmp_path, capsys, app):
    path, rate, args, check = _capture(tmp_path, app)
    spec = ["-a", app, "-i", f"iqfile:{path},rate={rate:.0f}"]
    outs = {k: str(tmp_path / f"{k}.json") for k in ("jax", "port")}
    assert jax_main(spec + ["-o", f"json:{outs['jax']}", *args]) == 0
    assert port_main(spec + ["-o", f"json:{outs['port']}", *args],
                     device="cpu") == 0
    lines = {k: open(v).read().splitlines() for k, v in outs.items()}
    assert lines["port"] == lines["jax"]
    recs = [json.loads(ln) for ln in lines["port"]]
    assert recs
    check(recs)
    capsys.readouterr()
    assert port_main(spec + ["-o", "print", *args], device="cpu") == 0
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == len(recs)


def test_digital_applications_are_registered():
    assert {"rx_rds", "rx_pocsag", "rx_ax25", "rx_ert"} <= set(APPLICATIONS)
    for name in ("rx_rds", "rx_pocsag", "rx_ax25", "rx_ert"):
        assert {"print", "json"} <= set(APPLICATIONS[name].supported_outputs)


@pytest.mark.parametrize("app,args", [
    ("rx_rds", ["0"]), ("rx_pocsag", ["0"]), ("rx_ax25", ["0"]),
    ("rx_ert", ["--protocols=scm"])])
def test_digital_applications_run_on_the_card_by_default(tmp_path, app,
                                                         args):
    """Without device="cpu" each application asks for the card, and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cap = str(tmp_path / "x.iq")
    np.zeros(2 * 4096, np.float32).tofile(cap)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["-a", app, "-i", f"iqfile:{cap},rate=1102500", "-o",
                   "print", *args])


@pytest.mark.parametrize("output", ["pulseaudio", "portaudio"])
def test_outputs_the_port_lacks_raise(tmp_path, output):
    """The name predates the port's audio outputs.  rx_rds's packets
    cannot go to an audio sink: both CLIs raise the block's ValueError
    when the graph is typed, before any library is loaded."""
    cap = tmp_path / "x"
    np.zeros(2 * 4096, np.float32).tofile(cap)
    argv = ["-a", "rx_rds", "-i", f"iqfile:{cap},rate=1102500", "-o",
            output, "0"]
    for run in (lambda: port_main(argv, device="cpu"),
                lambda: jax_main(argv)):
        with pytest.raises(ValueError, match="no type signature matches"):
            run()
