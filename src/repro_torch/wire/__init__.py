"""The worker->server wire: each worker's per-step payloads as one
contiguous uint8 buffer with a static offset table (DESIGN.md §6), so
the payload all-gather moves exactly the accounted bytes."""
from .codecs import NarrowIntCodec, RawCodec, index_domains, leaf_codecs
from .layout import (StagedWireLayout, WireLayout, WireSpec, build_layout,
                     build_staged_layout)

__all__ = ["RawCodec", "NarrowIntCodec", "leaf_codecs", "index_domains",
           "WireSpec", "WireLayout", "StagedWireLayout", "build_layout",
           "build_staged_layout"]
