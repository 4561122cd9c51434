"""Debug-mode numeric checks: the port's counterpart of
esp_audio_libs_tpu/utils/debug.py.

The integer codec paths are bit-exact by construction and pinned by the
differential tests; the f32 resampler path is where NaN or Inf can flow
silently into PCM (a NaN landing in a float buffer upstream, or a regression).
``checked(fn)`` runs ``fn`` under a ``TorchDispatchMode`` that raises
:class:`NumericCheckError` at the first op whose floating-point output holds
NaN or Inf, as ``checkify.float_checks`` raises at the op that produced it,
before a later quantize can hide it. Out-of-range indexing already raises in
PyTorch (``IndexError`` on the CPU, a device-side assert on the card), which
covers ``checkify.index_checks``.

Two things no op of the mode sees:
- the factory ops (``empty`` and its variants) return uninitialised memory,
  so their outputs are not inspected;
- the hand kernels write through ctypes into such buffers.
So the floating tensors passed to ``fn`` and those it returns are checked
too.

Opt-in by design: each checked op reads its output back (one device
synchronisation per op on the card), so serving runs unchecked, and to
debug, wrap the same function with ``checked``.
"""

from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["NumericCheckError", "checked", "checked_call"]

_aten = torch.ops.aten
# ops whose outputs are uninitialised memory by contract
_UNINITIALISED = {_aten.empty, _aten.empty_like, _aten.new_empty, _aten.empty_strided,
                  _aten.new_empty_strided}


class NumericCheckError(RuntimeError):
    """A checked function produced (or was given) NaN or Inf."""


def _check(tensors, where: str) -> None:
    for t in tensors:
        if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                and t.numel() and not bool(torch.isfinite(t).all())):
            kind = "NaN" if bool(torch.isnan(t).any()) else "Inf"
            raise NumericCheckError(f"{kind} in {where}")


class _FloatChecks(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket not in _UNINITIALISED:
            _check(tree_flatten(out)[0], f"the output of {func}")
        return out


def checked(fn):
    """Wrap ``fn`` so that NaN or Inf raises :class:`NumericCheckError`: in a
    floating argument, at the first op that produces it, or in a floating
    result. Returns a callable with ``fn``'s signature."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _check(tree_flatten((args, kwargs))[0], f"an argument of {fn.__name__}")
        with _FloatChecks():
            out = fn(*args, **kwargs)
        _check(tree_flatten(out)[0], f"the result of {fn.__name__}")
        return out

    return wrapper


def checked_call(fn, *args, **kwargs):
    """One-shot ``checked(fn)(*args, **kwargs)``."""
    return checked(fn)(*args, **kwargs)
