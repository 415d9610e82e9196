"""The wire: each worker's per-step payloads (worker->server), or the
server's model update (server->worker), as one contiguous uint8 buffer
with a static offset table (DESIGN.md §6, §9), so each collective moves
exactly the accounted bytes."""
from .codecs import NarrowIntCodec, RawCodec, index_domains, leaf_codecs
from .layout import (StagedWireLayout, WireLayout, WireSpec, build_layout,
                     build_staged_layout)

__all__ = ["RawCodec", "NarrowIntCodec", "leaf_codecs", "index_domains",
           "WireSpec", "WireLayout", "StagedWireLayout", "build_layout",
           "build_staged_layout"]
