"""Fault-tolerant training checkpoints: atomic, step-indexed, keep-last-k.

Counterpart of ``repro/train/checkpoint.py``, with its protocol and file
names (crash-safe at every point):

1. serialize to ``<dir>/tmp.<step>.<pid>`` (never a live name),
2. fsync the file,
3. ``os.replace`` it to ``<dir>/step_<n>.ckpt`` (atomic on POSIX),
4. write the ``LATEST`` marker the same way,
5. remove the checkpoints beyond the newest ``keep``.

Restore never trusts ``LATEST`` blindly: when the marked file is missing
or torn it falls back to the newest readable checkpoint.

The payload is ``repro``'s, ``{"step": n, "state": tree}``, with numpy
leaves on disk. numpy has no bfloat16, and ``repro``'s bf16 leaves are
``ml_dtypes`` arrays, whose pickle names the global ``ml_dtypes.bfloat16``.
The port needs no ``ml_dtypes`` either way:

* it writes a bf16 tensor's bits as an ``ml_dtypes`` array pickles, its
  dtype ``numpy.dtype(ml_dtypes.bfloat16)`` named by a hand-written global
  (``pickle`` would import the module to save a class of it), so
  ``repro``'s plain ``pickle.load`` gives an ``ml_dtypes`` bf16 leaf;
* it reads that global as a stand-in whose numpy dtype is the bits, an
  array of one int16 field named ``"bfloat16"``, which restore views as
  bf16 again. Older port checkpoints hold that structured array itself and
  restore the same way.

A payload is read by the serving checkpoints' unpickler
(``serve/recovery.py``: numpy and builtins) extended by ``AdamWState``,
under ``repro``'s module name or the port's, mapped to the port's class
without importing ``repro``, and by ``ml_dtypes.bfloat16`` and nothing
else of that module. So a ``repro`` training checkpoint restores into the
port leaf for leaf, bf16 ones too, and the reverse.
"""
from __future__ import annotations

import io
import os
import pickle
import re
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim.optimizers import AdamWState
from repro_torch.optim.tree import tree_map
from repro_torch.serve.recovery import _SafeUnpickler

__all__ = ["save", "restore", "latest_step", "list_steps"]

_CKPT_RE = re.compile(r"^step_(\d+)\.ckpt$")
_STATE_CLASSES = {("repro.optim.optimizers", "AdamWState"),
                  ("repro_torch.optim.optimizers", "AdamWState")}
# A protocol-5 pickle of a contiguous array rebuilds it from its bytes.
_FROMBUFFER = {("numpy._core.numeric", "_frombuffer"),
               ("numpy.core.numeric", "_frombuffer")}


# A bf16 tensor's bits in numpy, which has no bfloat16.
_BF16_BITS = np.dtype([("bfloat16", "<i2")])
_ML_DTYPES_BF16 = ("ml_dtypes", "bfloat16")
# ml_dtypes.bfloat16's dtype state, as numpy pickles it (ml_dtypes 0.5).
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


class _MLBfloat16Global:
    """Pickles as the global ``ml_dtypes.bfloat16`` (see ``_Pickler``)."""


class _MLBfloat16Dtype:
    """Pickles as ``numpy.dtype(ml_dtypes.bfloat16, False, True)``."""


_ML_BF16 = _MLBfloat16Global()
_ML_BF16_DTYPE = _MLBfloat16Dtype()


class _Pickler(pickle._Pickler):
    """A pickler that writes a bf16-bits array as ``repro``'s ``ml_dtypes``
    bf16 array pickles (``_reconstruct`` and a BUILD of its raw bytes, the
    dtype ``ml_dtypes.bfloat16``'s), without importing ``ml_dtypes``."""

    def save(self, obj, save_persistent_id=True):
        if obj is _ML_BF16:
            memo = self.memo.get(id(obj))
            if memo is not None:
                self.write(self.get(memo[0]))
                return
            self.write(pickle.GLOBAL + b"ml_dtypes\nbfloat16\n")
            self.memoize(obj)
            return
        super().save(obj, save_persistent_id)

    def reducer_override(self, obj):
        if obj is _ML_BF16_DTYPE:
            return np.dtype, (_ML_BF16, False, True), _BF16_DTYPE_STATE
        if isinstance(obj, np.ndarray) and obj.dtype == _BF16_BITS:
            fn, args, state = obj.__reduce__()
            return fn, args, (*state[:2], _ML_BF16_DTYPE, *state[3:])
        return NotImplemented


class _BF16Bits:
    """``ml_dtypes.bfloat16`` read without ``ml_dtypes``: numpy takes a
    class's ``dtype`` attribute, so ``numpy.dtype(_BF16Bits, ...)`` is the
    bits dtype."""

    dtype = _BF16_BITS


def _to_host(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def save(ckpt_dir: str, step: int, state: Any, *, keep: int = 3) -> str:
    """Atomically persist ``state`` (a tree of tensors or arrays) for
    ``step``. Returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"step": int(step), "state": tree_map(_to_host, state)}
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step}.ckpt")
    with open(tmp, "wb") as f:
        _Pickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)

    latest_tmp = os.path.join(ckpt_dir, f"tmp.latest.{os.getpid()}")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))

    for old in list_steps(ckpt_dir)[:-keep]:
        try:
            os.remove(os.path.join(ckpt_dir, f"step_{old}.ckpt"))
        except OSError:
            pass
    return final


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


class _TrainUnpickler(_SafeUnpickler):
    def find_class(self, module, name):
        if (module, name) in _STATE_CLASSES:
            return AdamWState
        if (module, name) == _ML_DTYPES_BF16:
            return _BF16Bits
        if (module, name) in _FROMBUFFER:
            return pickle.Unpickler.find_class(self, module, name)
        return super().find_class(module, name)


def _try_load(path: str) -> Optional[dict]:
    try:
        with open(path, "rb") as f:
            payload = _TrainUnpickler(io.BytesIO(f.read())).load()
    except (OSError, EOFError, pickle.UnpicklingError, ValueError,
            TypeError, IndexError, KeyError, AttributeError):
        return None
    if not isinstance(payload, dict) or "state" not in payload:
        return None
    return payload


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == _BF16_BITS:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def restore(ckpt_dir: str, step: Optional[int] = None, *,
            device="cuda") -> Optional[tuple[Any, int]]:
    """(state, step) of the newest readable checkpoint (or of ``step``),
    its leaves tensors on ``device``; None when there is none."""
    dev = resolve_device(device)
    if step is not None:
        candidates = [step]
    else:
        candidates = list(reversed(list_steps(ckpt_dir)))
        marker = os.path.join(ckpt_dir, "LATEST")
        if os.path.exists(marker):
            try:
                with open(marker) as f:
                    marked = int(f.read().strip())
            except (OSError, ValueError):
                marked = None
            if marked in candidates:  # prefer the marker if readable
                candidates.remove(marked)
                candidates.insert(0, marked)
    for s in candidates:
        payload = _try_load(os.path.join(ckpt_dir, f"step_{s}.ckpt"))
        if payload is not None:
            return (tree_map(lambda a: _to_tensor(a).to(dev),
                             payload["state"]), payload["step"])
    return None
