"""The pre-pack module: persistent block-major weight layout.

``PackedTensor`` holds a weight packed ONCE at load time — the paper's
"pack to a permanent memory address, reuse across calls".  Packing keeps
leading stack dims (layer-stacked weights pack per layer), folds alpha
like the paper's PACKA and zero-pads to block multiples, so the kernels
never see ragged blocks.  The layout is bit-identical to the reference
package's (``core/packing.py`` there).
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels import ops


@dataclasses.dataclass
class PackedTensor:
    """Block-major packed 2D weight, possibly with leading stack dims.

    blocks: (*lead, n0, n1, b0, b1) where the original matrix is
    (*lead, n0*b0 - pad0, n1*b1 - pad1).

    ``kernel_specs`` is the serving-replay stamp: sorted ``(batch_bucket,
    KernelSpec, ScheduleSpec)`` entries recording the variant the
    autotuner chose per bucket when the weight was packed
    (``core.tsmm.prepack_for``).  Empty for manually packed tensors."""

    blocks: object
    orig_rows: int
    orig_cols: int
    kernel_specs: tuple = ()

    @property
    def lead_shape(self):
        return tuple(self.blocks.shape[:-4])

    @property
    def shape(self):
        """Logical (unpacked, unpadded) shape."""
        return (*self.lead_shape, self.orig_rows, self.orig_cols)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def ndim(self):
        return len(self.shape)

    def __getitem__(self, i) -> "PackedTensor":
        """Index the leading stack dim (one layer of a stacked weight)."""
        if not self.lead_shape:
            raise IndexError("PackedTensor has no leading stack dim")
        return dataclasses.replace(self, blocks=self.blocks[i])

    def to(self, *args, **kw) -> "PackedTensor":
        return dataclasses.replace(self, blocks=self.blocks.to(*args, **kw))

    def unpack(self):
        return ops.unpack_blocks(self.blocks, self.orig_rows, self.orig_cols)


def pack(w, b0: int, b1: int, alpha: float = 1.0,
         impl=None) -> PackedTensor:
    """Pack the trailing 2 dims of ``w`` into (n0, n1, b0, b1) blocks
    (``impl``: ``kernels/tsmm.py``'s choice of the pack's version)."""
    rows, cols = w.shape[-2:]
    return PackedTensor(ops.pack_blocks(w, b0, b1, alpha, impl=impl), rows,
                        cols)


def is_packed(x) -> bool:
    return isinstance(x, PackedTensor)
