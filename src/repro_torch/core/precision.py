"""Stream codecs + storage-precision policy for the projection stream.

Port of `repro/core/precision.py`. One `StreamCodec` per wire format owns
how the filtered-projection stream is represented: encode (f32 -> wire),
decode (wire -> f32), the wire dtype, wire bytes per sample, and an
optional per-projection f32 scale sidecar.

  fp32 / bf16   plain casts.
  fp16          scale-on-overflow: s = max(1, max|q| / 65504), so in-range
                projections keep s = 1.0 exactly.
  fp8_e4m3      normalized: s = max|q| / 448, one f32 scale per projection.
  fp8_e5m2      normalized the same way, s = max|q| / 57344.

Encoded bytes and scales are bit-equal to the reference codec on the same
f32 input. The normalizing codecs bring every value to at most the wire
format's max before the cast, so the frameworks' different handling of
out-of-range fp8 casts (saturate here, NaN in JAX) never comes into play.

Decoding happens inside the back-projectors: taps are gathered in the wire
dtype, upcast to f32, and the per-projection scale multiplies the
accumulation weight. The voxel accumulator is always f32.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

_STORAGE_DTYPES = {
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
    "fp16": torch.float16,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
}
_CANONICAL = {
    "float32": "fp32", "f32": "fp32",
    "bfloat16": "bf16",
    "float16": "fp16", "half": "fp16",
    "fp8": "fp8_e4m3", "e4m3": "fp8_e4m3",
    "float8_e4m3": "fp8_e4m3", "float8_e4m3fn": "fp8_e4m3",
    "e5m2": "fp8_e5m2", "float8_e5m2": "fp8_e5m2",
}

# One f32 scale per projection: 4 bytes per projection on the wire.
SCALE_BYTES = 4


class EncodedStream(NamedTuple):
    """A filtered-projection batch in wire format: the quantized data and,
    for scaled codecs, one f32 scale per projection (else None)."""

    data: torch.Tensor
    scales: Optional[torch.Tensor]

    @property
    def nbytes(self) -> int:
        n = self.data.numel() * self.data.element_size()
        if self.scales is not None:
            n += self.scales.numel() * SCALE_BYTES
        return n


@dataclasses.dataclass(frozen=True)
class StreamCodec:
    """How the filtered-projection stream is represented on the wire."""

    name: str
    wire_dtype: torch.dtype
    has_scales: bool = False
    # Scaled codecs only: True normalizes every projection to the full wire
    # range (fp8); False scales only when the projection would overflow
    # (fp16), so in-range data stays bit-identical to a plain cast.
    normalize: bool = False

    @property
    def wire_bytes_per_sample(self) -> int:
        return self.wire_dtype.itemsize

    def sidecar_bytes(self, n_proj: int) -> int:
        """Bytes of the per-projection scale sidecar for `n_proj` frames."""
        return SCALE_BYTES * n_proj if self.has_scales else 0

    def wire_bytes(self, n_proj: int, n_v: int, n_u: int) -> int:
        """Total wire bytes of an encoded (n_proj, n_v, n_u) stream:
        quantized data + scale sidecar."""
        return (n_proj * n_v * n_u * self.wire_bytes_per_sample
                + self.sidecar_bytes(n_proj))

    def encode(self, q: torch.Tensor) -> EncodedStream:
        """f32 filtered projections (..., N_v, N_u) -> wire format."""
        if self.has_scales:
            fmax = float(torch.finfo(self.wire_dtype).max)
            q = q.to(torch.float32)
            amax = q.abs().amax(dim=(-2, -1))
            if self.normalize:
                scales = torch.where(amax > 0, amax / fmax,
                                     torch.ones_like(amax))
            else:
                scales = torch.clamp_min(amax / fmax, 1.0)
            data = (q / scales[..., None, None]).to(self.wire_dtype)
            return EncodedStream(data, scales)
        return EncodedStream(q.to(self.wire_dtype), None)

    def decode(self, data: torch.Tensor,
               scales: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Wire format -> f32 taps (the reference inverse of ``encode``)."""
        out = data.to(torch.float32)
        if self.has_scales:
            if scales is None:
                raise ValueError(
                    f"codec {self.name!r} needs its per-projection scale "
                    "sidecar to decode")
            out = out * scales[..., None, None].to(torch.float32)
        return out


CODECS = {
    "fp32": StreamCodec("fp32", torch.float32),
    "bf16": StreamCodec("bf16", torch.bfloat16),
    "fp16": StreamCodec("fp16", torch.float16, has_scales=True),
    "fp8_e4m3": StreamCodec("fp8_e4m3", torch.float8_e4m3fn,
                            has_scales=True, normalize=True),
    "fp8_e5m2": StreamCodec("fp8_e5m2", torch.float8_e5m2,
                            has_scales=True, normalize=True),
}


def codec_for(name: str) -> StreamCodec:
    """Resolve a storage name (or alias) to its StreamCodec."""
    return Precision(name).codec


def default_storage(device="cuda") -> str:
    """fp16 on the CUDA card (the paper's texture dtype), bf16 elsewhere."""
    return "fp16" if torch.device(device).type == "cuda" else "bf16"


@dataclasses.dataclass(frozen=True)
class Precision:
    """Projection-stream precision policy: storage codec + f32 accumulate."""

    storage: str = "fp32"

    def __post_init__(self):
        name = _CANONICAL.get(self.storage, self.storage)
        if name not in _STORAGE_DTYPES:
            raise ValueError(
                f"unknown storage precision {self.storage!r}; "
                f"choose from {sorted(_STORAGE_DTYPES)}"
            )
        object.__setattr__(self, "storage", name)

    @property
    def codec(self) -> StreamCodec:
        return CODECS[self.storage]

    @property
    def storage_dtype(self) -> torch.dtype:
        return _STORAGE_DTYPES[self.storage]

    @property
    def accum_dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def storage_bytes(self) -> int:
        """Wire bytes per sample (the scale sidecar is priced separately)."""
        return self.storage_dtype.itemsize

    def eps(self) -> float:
        """Machine epsilon of the storage dtype (the quantization step)."""
        return float(torch.finfo(self.storage_dtype).eps)

    def rmse_tol(self) -> float:
        """Relative-RMSE acceptance bound vs an fp32 oracle: 2*eps, or eps/4
        for the normalizing (fp8) codecs; fp32 keeps the paper's 1e-5."""
        if self.codec.normalize:
            return max(1e-5, self.eps() / 4)
        return max(1e-5, 2.0 * self.eps())

    def max_tol(self) -> float:
        """Relative max-abs-error bound vs an fp32 oracle (no averaging)."""
        if self.codec.normalize:
            return max(1e-4, self.eps())
        return max(1e-4, 8.0 * self.eps())

    def sidecar_bytes(self, n_proj: int) -> int:
        return self.codec.sidecar_bytes(n_proj)

    def wire_bytes(self, n_proj: int, n_v: int, n_u: int) -> int:
        return self.codec.wire_bytes(n_proj, n_v, n_u)

    def allgather_bytes(self, n_proj: int, n_v: int, n_u: int) -> int:
        """Per-rank AllGather payload for the filtered-projection stream."""
        return self.wire_bytes(n_proj, n_v, n_u)


def resolve_precision(precision: "Precision | str | None",
                      device="cuda") -> Precision:
    """None -> the device's default; str -> Precision(str); Precision -> itself."""
    if precision is None:
        return Precision(default_storage(device))
    if isinstance(precision, str):
        return Precision(precision)
    return precision


def psnr(x, ref, data_range: float | None = None) -> float:
    """Peak signal-to-noise ratio of x against ref (arrays or tensors on any
    device), in dB."""
    x, ref = (np.asarray(a.detach().cpu() if torch.is_tensor(a) else a,
                         np.float64) for a in (x, ref))
    if data_range is None:
        data_range = float(ref.max() - ref.min())
    mse = float(np.mean((x - ref) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(data_range * data_range / mse)
