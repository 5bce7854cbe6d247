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
  arrays -> tensors, complex kept complex.
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


__all__ = ["tensor_from_jax", "block_state_from_jax",
           "flagship_state_from_jax"]
