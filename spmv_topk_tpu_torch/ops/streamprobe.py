"""Stream probe (kernel K3): read the packed word stream once.

The benchmark's stream floor: the rate at which the card delivers the
same words the Top-K sweep reads, with one add per word, so a sweep's
time can be read against what this card delivers in the same run.
``stream_words_device`` launches ``csrc/stream_probe.cu`` on a CUDA
tensor and runs ``stream_words_plain`` on a CPU tensor.
"""

from __future__ import annotations

import torch

from ..config import LANES
from . import _build

_S = 8
_BLOCKS_PER_SM = 8


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
    if salt.device != dev or salt.dtype != torch.int32 or salt.numel() != LANES:
        raise ValueError(f"salt must be (1, {LANES}) int32 on {dev}")
    out = salt.reshape(1, LANES).expand(_S, LANES).contiguous()
    num_chunks = words.shape[0] // _S
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nblk = max(1, min(sms * _BLOCKS_PER_SM, num_chunks))
    lib = _build.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.stream_words(words.data_ptr(), num_chunks, out.data_ptr(),
                               nblk, stream)
    _build.check(err, "stream_words")
    stream_words_device.launches += 1
    return out


stream_words_device.launches = 0
