"""soundkit-tpu: a batched multi-stream audio decode/encode + DSP framework.

A from-scratch rebuild of the capabilities of wavey-ai/soundkit (a Rust
streaming audio codec workspace) designed for an accelerator:

- Host layer (Python + C++): byte ingestion, format detection, container
  demux, bitstream/entropy parsing. Produces fixed-shape coefficient
  tensors + per-stream state.
- Device layer (JAX/XLA): batched kernels over ``[streams, ...]``
  for companding, ADPCM scans, IMDCT/DCT-IV, polyphase synthesis, LPC
  reconstruction, windowed-sinc resampling and sample-format conversion.
- Pipeline layer: ``DecodePipeline``-style streaming API with automatic
  format detection, plus a batched multi-stream scheduler.

Reference behavior is documented per-module with citations into the
upstream soundkit sources (e.g. ``soundkit/src/audio_bytes.rs``).
"""

__version__ = "0.1.0"

from soundkit_tpu.core.audio_types import (  # noqa: F401
    AudioData,
    EncodingFlag,
    Endianness,
    PcmData,
)
