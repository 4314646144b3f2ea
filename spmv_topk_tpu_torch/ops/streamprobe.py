"""Stream probe (kernel K3): read the packed word stream once.

The benchmark's stream floor: the rate at which the card delivers the
same words the Top-K sweep reads, with one add per word, so a sweep's
time can be read against what this card delivers in the same run.
``stream_words_device`` launches ``csrc/stream_probe.cu`` on a CUDA
tensor, one launch a call that seeds the salt itself (no torch op before
or after it), and runs ``stream_words_plain`` on a CPU tensor.
"""

from __future__ import annotations

import contextlib

import torch

from ..config import LANES
from . import _build
from .kernel import _device_info, _merge_workspace

_S = 8
# the kernel's accumulator (one (8, 128) chunk of uint32) and its ticket,
# zeros that each launch leaves 0
_WORKSPACE = _S * LANES + 1


def stream_words_plain(words: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """(8, 128) int32: salt[l] + the sum of every (8, 128) chunk of
    ``words``, with int32 wraparound. ``torch.sum`` of int32 gives int64,
    so the sum is taken exactly in int64 and wrapped back explicitly."""
    s = words.reshape(-1, _S, LANES).sum(dim=0, dtype=torch.int64)
    s = (s + salt.reshape(1, LANES).to(torch.int64)) & 0xFFFFFFFF
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def stream_words_device(words: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """Stream ``words`` ((n * 8, 128) int32) once; returns the (8, 128)
    int32 checksum seeded with ``salt`` ((1, 128) int32). Vary the salt
    between timed runs so no run can be skipped as a repeat."""
    if words.ndim != 2 or words.shape[1] != LANES or words.shape[0] % _S:
        raise ValueError(f"words must be (n * {_S}, {LANES}), "
                         f"got {tuple(words.shape)}")
    if words.device.type == "cpu":
        return stream_words_plain(words, salt)
    dev = words.device
    if dev.type != "cuda":
        raise ValueError(f"words on {dev}: the stream probe needs CUDA")
    if words.dtype != torch.int32 or not words.is_contiguous() \
            or words.data_ptr() % 16:
        raise ValueError("words must be contiguous 16-byte aligned int32")
    if salt.device != dev or salt.dtype != torch.int32 or \
            salt.numel() != LANES or not salt.is_contiguous():
        raise ValueError(f"salt must be (1, {LANES}) int32 on {dev}")
    num_chunks = words.shape[0] // _S
    if num_chunks < 1:
        raise ValueError("words hold no chunk")
    lib = _build.lib()
    with (contextlib.nullcontext() if torch.cuda.current_device() == dev.index
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        _, ws = _merge_workspace("k3", dev, stream, 0, _WORKSPACE)
        out = torch.empty((_S, LANES), dtype=torch.int32, device=dev)
        err = lib.stream_words(words.data_ptr(), num_chunks, salt.data_ptr(),
                               ws.data_ptr(), out.data_ptr(),
                               _device_info(dev)[0], stream)
    _build.check(err, "stream_words")
    stream_words_device.launches += 1
    return out


stream_words_device.launches = 0
