"""The port's flagship step (luaradio_tpu_torch/parallel/flagship.py)
against the JAX package's step and the float64 oracle of
tests/parallel/test_mesh_runner.py, whole, chunked, and resumed from
state carried over from the JAX package."""

import numpy as np
import pytest
import scipy.signal
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from luaradio_tpu.parallel.flagship import \
    make_wbfm_mono_step as jax_step  # noqa: E402
from luaradio_tpu_torch.interop import flagship_state_from_jax  # noqa: E402
from luaradio_tpu_torch.parallel.flagship import (  # noqa: E402
    INV_GAIN, make_wbfm_mono_step, wbfm_mono_taps)

IF_RATE, DECIM, TAU, NTAPS = 256e3, 8, 75e-6, 128
C = 2


def _iq(seed, t):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((C, t)) + 1j * rng.standard_normal((C, t))
            ).astype(np.complex64)


def _pay(z):
    return np.ascontiguousarray(z).view(np.float32)


def _close(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    scale = max(1.0, float(np.max(np.abs(exp))))
    assert np.max(np.abs(got - exp)) < 2e-5 * scale


def _port_run(z, chunk):
    step, init = make_wbfm_mono_step(IF_RATE, DECIM, TAU, NTAPS,
                                     device="cpu")
    st = init(C)
    outs = []
    for i in range(0, z.shape[-1], chunk):
        st, a = step(st, torch.from_numpy(_pay(z[:, i:i + chunk])))
        outs.append(a.numpy())
    return np.concatenate(outs, axis=-1), st


def _oracle(z):
    """discriminator -> LPF -> deemphasis IIR -> decimate, in float64."""
    from luaradio_tpu.blocks.signal.filtering import \
        _singlepole_lowpass_coeffs
    from luaradio_tpu.utils import filter_design
    taps = filter_design.firwin_lowpass(NTAPS, 15e3 / (IF_RATE / 2))
    b, a = _singlepole_lowpass_coeffs(1 / (2 * np.pi * TAU), IF_RATE)
    out = []
    for ch in range(z.shape[0]):
        x = z[ch].astype(np.complex128)
        prev = np.concatenate([[0j], x[:-1]])
        m = np.angle(x * np.conj(prev)) / (2 * np.pi * 1.25)
        y = scipy.signal.lfilter(b, a, scipy.signal.lfilter(taps, [1.0], m))
        out.append(y[::DECIM])
    return np.stack(out)


@pytest.mark.parametrize("chunk", [8192, 2048, 1000 * 8],
                         ids=["whole", "chunked", "ragged"])
def test_step_matches_oracle_and_jax(chunk):
    z = _iq(11, 8192)
    got, _ = _port_run(z, chunk)
    _close(got, _oracle(z))
    step, init = jax_step(IF_RATE, DECIM, TAU, NTAPS, use_pallas=False)
    st, outs = init(C), []
    for i in range(0, z.shape[-1], chunk):
        st, a = step(st, jnp.asarray(_pay(z[:, i:i + chunk])))
        outs.append(np.asarray(a))
    _close(got, np.concatenate(outs, axis=-1))


def test_taps_match_jax_kernel_taps():
    """The port folds the same filter as the JAX step (K = 640 after
    padding to 128s: 128 LPF taps + the 443-tap deemphasis response)."""
    from luaradio_tpu.blocks.signal.filtering import \
        _singlepole_lowpass_coeffs
    from luaradio_tpu.ops.fir import combine_taps, iir_to_fir_taps
    from luaradio_tpu.utils import filter_design
    taps = wbfm_mono_taps(IF_RATE, TAU, NTAPS)
    b, a = _singlepole_lowpass_coeffs(1 / (2 * np.pi * TAU), IF_RATE)
    ref = combine_taps(filter_design.firwin_lowpass(NTAPS, 15e3 / 128e3),
                       iir_to_fir_taps(b, a, tol=1e-10)).astype(np.float32)
    assert len(taps) == 640
    assert np.array_equal(taps[:len(ref)], ref)
    assert not taps[len(ref):].any()


@pytest.mark.parametrize("path", ["xla", "pallas"])
def test_resume_from_jax_state(path):
    """Run two chunks in JAX, carry its state into the port, run the third
    chunk in both packages: the outputs agree (the Pallas path runs in
    interpret mode at its own tile of 16384 samples)."""
    t = 16384 if path == "pallas" else 4096
    z = _iq(12, 3 * t)
    step, init = jax_step(IF_RATE, DECIM, TAU, NTAPS,
                          use_pallas=(path == "pallas"))
    st = init(C)
    for i in range(2):
        st, _ = step(st, jnp.asarray(_pay(z[:, i * t:(i + 1) * t])))
    third = _pay(z[:, 2 * t:])
    _, exp = step(st, jnp.asarray(third))
    pstep, _ = make_wbfm_mono_step(IF_RATE, DECIM, TAU, NTAPS, device="cpu")
    pst = flagship_state_from_jax(tuple(np.asarray(s) for s in st),
                                  INV_GAIN, device="cpu")
    assert pst[0].shape == (C, 640) and pst[0].dtype == torch.complex64
    _, got = pstep(pst, torch.from_numpy(third))
    _close(got.numpy(), exp)


def test_state_carry_is_last_samples():
    z = _iq(13, 4096)
    _, st = _port_run(z, 2048)
    assert np.array_equal(st[0].numpy(), z[:, -640:])


def test_default_device_is_cuda():
    """Entry points run on the card unless asked for the CPU; without a
    card they raise rather than run on the CPU."""
    if torch.cuda.is_available():
        step, init = make_wbfm_mono_step()
        assert init(1)[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_wbfm_mono_step()
