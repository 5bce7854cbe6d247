"""Streaming state from the JAX package into the port.

The port's state is filter taps and streaming carries; these functions turn
the JAX package's (numpy-fetched) state into the port's tensors, so a
stream started in one package can be resumed in the other:

* the flagship kernel carry, interleaved float32 [C, 2K] -> complex64
  [C, K] (the same bytes);
* the flagship fused-XLA state ``(prev_re, prev_im, fir_tail)``: the last
  sample and the last K-1 discriminator outputs.  The port's single state
  form is the last K samples, so the discriminator history is integrated
  back into unit-magnitude samples ending at the last sample; the
  discriminator gives back the same outputs up to float32 rounding;
* a block's state (a tail of input samples, a phase, a filter state):
  arrays -> tensors, complex kept complex;
* a PLLBlock's state (phi_locked, phi_multiplied, freq): the phases
  wrapped to [-pi, pi], the range the port's sequential kernel converts
  to int32 turns (the JAX package's CPU loop keeps them in (-2 pi, 2 pi));
* the leaf blocks of a composite (the stereo demodulator): each JAX
  block's state into the form its port twin carries, where a JAX FIR
  above 16 taps keeps the last L input samples of its FFT frame and the
  port keeps the last M-1.
"""

from __future__ import annotations

import numpy as np
import torch

from luaradio_tpu_torch.core.platform import resolve_device


def tensor_from_jax(arr, device=None) -> torch.Tensor:
    """A JAX array (or anything numpy takes) -> tensor on ``device``."""
    a = np.array(arr)          # copies: JAX buffers are read-only
    return torch.from_numpy(a).to(resolve_device(device))


def block_state_from_jax(state, device=None):
    """A JAX block's state (array, scalar, or tuple/list of them) -> the
    port block's state, structure kept."""
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(block_state_from_jax(s, device) for s in state)
    return tensor_from_jax(state, device)


def flagship_state_from_jax(state, inv_gain: float, device=None):
    """The JAX flagship step's state (either path) -> the port's
    ``(carry,)`` with carry complex64 [C, K]."""
    dev = resolve_device(device)
    if len(state) == 1:                       # Pallas kernel carry
        pair = np.array(state[0], dtype=np.float32)
        return (torch.from_numpy(pair.view(np.complex64).copy()).to(dev),)
    prev_re, prev_im, tail = (np.asarray(s, np.float64) for s in state)
    prev = prev_re[..., -1] + 1j * prev_im[..., -1]              # [C]
    theta = tail / np.float64(np.float32(inv_gain))              # [C, K-1]
    mag = np.abs(prev)
    start = np.where(mag > 0, prev / np.where(mag > 0, mag, 1), 1.0)
    # w[i] = w[i+1] * exp(-j theta[i]), backwards from w[K-1] = prev
    back = np.cumsum(theta[..., ::-1], axis=-1)[..., ::-1]
    carry = start[..., None] * np.exp(-1j * back)
    carry = np.concatenate([carry, prev[..., None]], axis=-1)
    return (torch.from_numpy(carry.astype(np.complex64)).to(dev),)


def pll_state_from_jax(state, device=None):
    """A JAX PLLBlock's (phi_l, phi_m, freq) -> the port PLLBlock's state:
    0-dim float32 tensors, phases wrapped to [-pi, pi]."""
    dev = resolve_device(device)
    phi_l, phi_m, freq = (np.float64(np.array(s)) for s in state)
    wrap = lambda p: np.float32(np.angle(np.exp(1j * p)))  # noqa: E731
    return tuple(torch.tensor(v, dtype=torch.float32, device=dev)
                 for v in (wrap(phi_l), wrap(phi_m), np.float32(freq)))


def state_for_block(block, state, device=None):
    """A JAX block's state -> the state of ``block``, its port twin (set
    up already): PLL phases wrapped, sample tails cut to the length the
    port block carries."""
    from luaradio_tpu_torch.blocks.signal.carrier import PLLBlock
    if isinstance(block, PLLBlock):
        return pll_state_from_jax(state, device)
    got = block_state_from_jax(state, device)
    want = block.init_state()
    if isinstance(want, torch.Tensor) and isinstance(got, torch.Tensor) \
            and want.dim() and got.dim() and got.shape[-1] > want.shape[-1]:
        got = got[..., got.shape[-1] - want.shape[-1]:].contiguous()
    return got


def composite_states_from_jax(jax_composite, port_composite, states,
                              device=None) -> dict:
    """States of a JAX composite's leaf blocks -> {port leaf block: state}.

    ``states`` maps each JAX leaf block to its state; the leaves of the two
    composites (built with the same arguments) pair up in flattening
    order."""
    jax_leaves = jax_composite._flatten()[0]
    port_leaves = port_composite._flatten()[0]
    if len(jax_leaves) != len(port_leaves):
        raise ValueError(f"{len(jax_leaves)} JAX leaf blocks against "
                         f"{len(port_leaves)} in the port")
    out = {}
    for jb, pb in zip(jax_leaves, port_leaves):
        if type(jb).__name__ != type(pb).__name__:
            raise ValueError(f"leaf {jb.name} pairs with {pb.name}")
        out[pb] = state_for_block(pb, states[jb], device)
    return out


__all__ = ["tensor_from_jax", "block_state_from_jax",
           "flagship_state_from_jax", "pll_state_from_jax",
           "state_for_block", "composite_states_from_jax"]
