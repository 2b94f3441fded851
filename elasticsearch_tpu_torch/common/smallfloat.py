"""Lucene SmallFloat byte315 norm codec (a copy of the JAX package's
`common/smallfloat.py`), plus its 256-entry decode tables as torch tensors.

Norms are one byte per document per field: encode(1/sqrt(field length)) with
3 mantissa bits and 5 exponent bits. Hit order depends on this exact
quantization, so the host codec and the device tables must agree bit for
bit (tests/test_torch_pack.py pins both against the JAX package)."""

from __future__ import annotations

import numpy as np
import torch


def float_to_byte315(f: np.ndarray | float) -> np.ndarray:
    """Encode float32 → uint8 with 3 mantissa bits / 5 exponent bits / zero-exp 15."""
    arr = np.atleast_1d(np.asarray(f, dtype=np.float32))
    bits = arr.view(np.int32)
    small = bits >> 21  # 24-3 mantissa shift
    floor = (63 - 15) << 3
    out = np.empty(arr.shape, dtype=np.uint8)
    too_small = small <= floor
    too_large = small >= floor + 0x100
    mid = ~(too_small | too_large)
    # underflow → 0 for non-positive, 1 for tiny positives
    out[too_small] = np.where(bits[too_small] <= 0, 0, 1).astype(np.uint8)
    out[too_large] = 255
    out[mid] = (small[mid] - floor).astype(np.uint8)
    return out


def byte315_to_float(b: np.ndarray | int) -> np.ndarray:
    """Decode uint8 → float32. byte315_to_float(float_to_byte315(x)) quantizes x."""
    barr = np.atleast_1d(np.asarray(b, dtype=np.uint8))
    bits = (barr.astype(np.int32) << 21) + ((63 - 15) << 24)
    out = bits.view(np.float32).copy()
    out[barr == 0] = 0.0
    return out


NORM_TABLE: np.ndarray = byte315_to_float(np.arange(256, dtype=np.uint8))


def encode_norm(num_terms: np.ndarray | int, boost: float = 1.0) -> np.ndarray:
    """Norm byte for a field with `num_terms` tokens: encode(boost / sqrt(numTerms))."""
    n = np.maximum(np.atleast_1d(np.asarray(num_terms, dtype=np.float64)), 0)
    with np.errstate(divide="ignore"):
        f = np.where(n > 0, boost / np.sqrt(n), 0.0).astype(np.float32)
    return float_to_byte315(f)


def decode_norm_doclen(norm_byte: np.ndarray) -> np.ndarray:
    """BM25: the decoded value f stands for 1/sqrt(len); doc length = 1/f²
    (quantized). Bytes decoding to 0 (empty field) get length 0."""
    f = NORM_TABLE[np.asarray(norm_byte, dtype=np.uint8)]
    with np.errstate(divide="ignore"):
        dl = np.where(f > 0, 1.0 / (f * f), 0.0)
    return dl.astype(np.float32)


def norm_table(device) -> torch.Tensor:
    """The byte315 decode table as a float32 [256] tensor on `device`."""
    return torch.from_numpy(NORM_TABLE.astype(np.float32)).to(device)


def byte315_to_float_t(b: torch.Tensor) -> torch.Tensor:
    """Device byte315 decode: a uint8/int tensor → float32 through the
    256-entry table, bitwise equal to the host `byte315_to_float`."""
    return norm_table(b.device)[b.long()]


def doclen_table(device) -> torch.Tensor:
    """The BM25 doc-length table (`decode_norm_doclen` over all 256 bytes)
    as a float32 [256] tensor on `device`."""
    return torch.from_numpy(
        decode_norm_doclen(np.arange(256, dtype=np.uint8))).to(device)
