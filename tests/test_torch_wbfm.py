"""K1/K2 (luaradio_tpu_torch/ops/wbfm.py): the plain PyTorch twins that the
CUDA kernels are held against on the card, compared here with the JAX
package's Pallas kernels (interpret mode) and their XLA fallback on the
same numpy inputs; plus the wrappers' checks and dispatch."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from luaradio_tpu.ops.wbfm_pallas import (make_disc_fir_pallas,  # noqa: E402
                                          make_wbfm_pallas)
from luaradio_tpu_torch.ops import cudabuild, wbfm  # noqa: E402

INV_GAIN = float(np.float32(1.0 / (2 * np.pi * 1.25)))
C, D, K = 2, 8, 256


def _signal(rng, c, t):
    """FM-like test signal: smooth phase walk plus noise, so both the
    discriminator and the FIR see realistic values."""
    ph = np.cumsum(0.4 * rng.standard_normal((c, t)), axis=-1)
    z = np.exp(1j * ph) + 0.05 * (rng.standard_normal((c, t))
                                  + 1j * rng.standard_normal((c, t)))
    return z.astype(np.complex64)


def _taps(rng, k=K):
    h = np.hanning(k) * rng.standard_normal(k) * 0.1
    return h.astype(np.float32)


def _close(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    scale = max(1.0, float(np.max(np.abs(exp))))
    assert np.max(np.abs(got - exp)) < 2e-5 * scale


def _wrap_diff(a, b, period):
    d = np.mod(np.asarray(a, np.float64) - np.asarray(b, np.float64)
               + period / 2, period) - period / 2
    return np.max(np.abs(d))


@pytest.mark.parametrize("t, chunks", [(2048, 2), (3 * 1024 + 8 * 37, 1)],
                         ids=["tiled", "ragged"])
def test_k1_twin_matches_pallas_kernel(t, chunks):
    """Tiled T runs the Pallas kernel (interpret mode), ragged T its XLA
    fallback; the port's twin takes any T.  Chained over chunks through
    the carried state."""
    rng = np.random.default_rng(1)
    taps = _taps(rng)
    z = _signal(rng, C, t * chunks)
    fused = make_wbfm_pallas(taps, D, INV_GAIN, tile=1024, block=128,
                             interpret=True)
    jc = jnp.zeros((C, 2 * K), jnp.float32)
    pc = torch.zeros((C, K), dtype=torch.complex64)
    th = torch.from_numpy(taps)
    for i in range(chunks):
        pay = np.ascontiguousarray(z[:, i * t:(i + 1) * t]).view(np.float32)
        jc, ja = fused(jc, jnp.asarray(pay))
        pc, pa = wbfm.wbfm_mono(pc, torch.from_numpy(pay), th, D, INV_GAIN)
        _close(pa.numpy(), ja)
        assert np.array_equal(
            pc.numpy(), np.asarray(jc).view(np.complex64))


@pytest.mark.parametrize("t", [2048, 3 * 1024 + 8 * 37],
                         ids=["tiled", "ragged"])
def test_k2_twin_matches_pallas_kernel(t):
    rng = np.random.default_rng(2)
    taps = _taps(rng)
    z = _signal(rng, C, t + K)
    carry, x = np.ascontiguousarray(z[:, :K]), np.ascontiguousarray(z[:, K:])
    fused = make_disc_fir_pallas(taps, D, INV_GAIN, tile=1024, block=128,
                                 interpret=True)
    ja = fused(jnp.asarray(carry.real), jnp.asarray(carry.imag),
               jnp.asarray(x.real), jnp.asarray(x.imag))
    pa = wbfm.disc_fir(torch.from_numpy(carry), torch.from_numpy(x),
                       torch.from_numpy(taps), D, INV_GAIN)
    _close(pa.numpy(), ja)


def test_k1_and_k2_twins_agree():
    """The two entry points are one computation on two layouts."""
    rng = np.random.default_rng(3)
    taps = torch.from_numpy(_taps(rng))
    z = _signal(rng, C, 4096 + K)
    carry = torch.from_numpy(np.ascontiguousarray(z[:, :K]))
    x = torch.from_numpy(np.ascontiguousarray(z[:, K:]))
    pay = torch.view_as_real(x).reshape(C, -1)
    _, a = wbfm.wbfm_mono(carry, pay, taps, D, INV_GAIN)
    b = wbfm.disc_fir(carry, x, taps, D, INV_GAIN)
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["random", "cold_start", "branch_cut"])
def test_discriminator_matches_arctan2(case):
    """m against jnp.arctan2 of the reference's conj-multiply, wrap-aware
    (near +-pi a last-ulp difference flips m by a full turn)."""
    rng = np.random.default_rng(4)
    z = _signal(rng, C, 4096)
    if case == "cold_start":
        z[:, :1000] = 0
    elif case == "branch_cut":
        # consecutive samples ~pi apart: tre < 0 and tim ~ 0
        z = np.exp(1j * np.pi * np.arange(4096)
                   + 1e-7j * rng.standard_normal((C, 4096))).astype(
                       np.complex64)
    re, im = np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)
    rp, ip, rc, ic = re[:, :-1], im[:, :-1], re[:, 1:], im[:, 1:]
    exp = np.asarray(jnp.arctan2(jnp.asarray(ic * rp - rc * ip),
                                 jnp.asarray(rc * rp + ic * ip)) * INV_GAIN)
    got = wbfm.discriminate(torch.from_numpy(re), torch.from_numpy(im),
                            INV_GAIN).numpy()
    assert _wrap_diff(got, exp, 2 * np.pi * INV_GAIN) < 2e-6
    if case == "cold_start":
        assert np.all(got[:, :999] == 0)


def _args(c=2, t=64, k=16):
    carry = torch.zeros((c, k), dtype=torch.complex64)
    x = torch.zeros((c, 2 * t), dtype=torch.float32)
    xc = torch.zeros((c, t), dtype=torch.complex64)
    taps = torch.zeros(k, dtype=torch.float32)
    return carry, x, xc, taps


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "ragged",
                                 "taps", "carry"])
def test_wrappers_reject_bad_inputs(bad):
    carry, x, xc, taps = _args()
    if bad == "dtype":
        x, xc = x.double(), xc.to(torch.complex128)
    elif bad == "shape":
        x, xc = x[:, :-1], xc[None]
    elif bad == "contiguity":
        x = torch.zeros((2, 256))[:, ::2]
        xc = torch.zeros((2, 128), dtype=torch.complex64)[:, ::2]
    elif bad == "ragged":
        x, xc = torch.zeros((2, 2 * 60)), torch.zeros(
            (2, 60), dtype=torch.complex64)
    elif bad == "taps":
        taps = taps.double()
    else:
        carry = carry[:1]
    with pytest.raises(ValueError):
        wbfm.wbfm_mono(carry, x, taps, 8, INV_GAIN)
    with pytest.raises(ValueError):
        wbfm.disc_fir(carry, xc, taps, 8, INV_GAIN)


def test_wbfm_mono_rejects_misaligned_samples():
    """A contiguous view at an odd float offset passes every other check,
    but K1 reads I/Q pairs as 8-byte float2: the wrapper refuses it."""
    carry, _, _, taps = _args()
    flat = torch.zeros(1 + 2 * 2 * 64, dtype=torch.float32)
    x = flat[1:].view(2, 2 * 64)
    assert x.is_contiguous() and x.data_ptr() % 8 == 4
    with pytest.raises(ValueError, match="8-byte"):
        wbfm.wbfm_mono(carry, x, taps, 8, INV_GAIN)


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    carry, x, xc, taps = _args()
    before = (wbfm.wbfm_mono.launches, wbfm.disc_fir.launches)
    nc, a = wbfm.wbfm_mono(carry, x, taps, 8, INV_GAIN)
    b = wbfm.disc_fir(carry, xc, taps, 8, INV_GAIN)
    assert a.shape == b.shape == (2, 8) and nc.shape == (2, 16)
    assert (wbfm.wbfm_mono.launches, wbfm.disc_fir.launches) == before


def test_short_chunk_carry():
    """T < K: the new carry still holds the last K window samples."""
    rng = np.random.default_rng(6)
    z = _signal(rng, 1, 16 + 40)
    carry = torch.from_numpy(np.ascontiguousarray(z[:, :40]))
    x = torch.view_as_real(torch.from_numpy(
        np.ascontiguousarray(z[:, 40:]))).reshape(1, -1)
    nc, _ = wbfm.wbfm_mono(carry, x, torch.zeros(40), 8, INV_GAIN)
    assert np.array_equal(nc.numpy(), z[:, -40:])


@pytest.mark.parametrize("k, d, ok", [(640, 8, True), (512, 5, True),
                                      (256, 8, True), (640, 128, False)])
def test_kernel_capacity(k, d, ok):
    """The flagship (K 640, D 8) and graph (K 512, D 5) shapes fit the
    kernel's shared memory; a very large decimation (K 640, D 128: its
    sample stages alone take 131 KB) does not, and the wrappers refuse it
    before launching."""
    assert wbfm.fits(k, d) is ok
    if not ok:
        carry, x, xc, taps = _args(t=64 * d // 8 * 8, k=k)
        with pytest.raises(ValueError, match="shared memory"):
            wbfm.disc_fir(carry, torch.zeros((2, 64 * d),
                                              dtype=torch.complex64),
                          taps, d, INV_GAIN)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """The kernels build at first use; without nvcc that fails loudly."""
    monkeypatch.setattr(cudabuild.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        cudabuild.nvcc()


def test_library_is_keyed_by_source_hash():
    p = cudabuild.library_path("wbfm")
    assert p.parent == cudabuild.BUILD_DIR
    assert p.name.startswith("libwbfm-") and p.suffix == ".so"
    assert p == cudabuild.library_path("wbfm")
