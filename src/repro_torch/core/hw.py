"""Hardware model for the port's target: one NVIDIA H100 SXM.

``HwSpec`` keeps the reference package's fields (``core/hw.py`` there), so
a spec written for either package can be rebuilt field by field in the
other and the cost model ranks identically.  On the H100 the fields read:

* ``peak_flops_bf16`` / ``hbm_bw`` / ``hbm_bytes`` — the data sheet's
  dense bf16 tensor-core rate, HBM3 bandwidth and capacity;
* ``ici_bw_per_link`` / ``ici_links`` — NVLink 4: 18 links of 25 GB/s
  each way (450 GB/s each way per card);
* ``vmem_bytes`` — the on-chip budget the feasibility gate charges a
  plan's working set against: the shared memory one CTA may opt into
  (227 KB).  On a card it is read from the device;
* ``mxu_dim`` — the row count of one ``wgmma`` tile (64);
* ``sublane`` — the row granularity the cost model pads the skinny
  operand to.  The CUDA kernel masks ragged rows itself, so this is the
  8-row tile of its small-m path for every dtype.

``sm_count`` is the number of streaming multiprocessors (132 on the SXM
part), read from the device on a card.

``peak_flops_fp32`` is the float32 rate of the kernels that take float32.
The port's fp32 kernels are SIMT (no tensor cores), so on the H100 it is
the data sheet's FP32 rate outside the tensor cores, 67 TFLOP/s, not a
fraction of the bf16 tensor-core peak.  0 keeps the reference's rate,
bf16 / 4 (its matrix unit runs fp32 in passes), so a spec rebuilt from
the reference's fields ranks as the reference does.

``pack_once`` says where the pack of a packed tall A is paid.  False (the
default, serving): ``tsmm_dot`` packs a tall A on every call, so the
launch gate's model charges that pack (``smem_model.call_pack_bytes``),
the evaluator times it inside the call and a natural-A sibling competes
with each packed plan.  True (the paper's data reuse, its Eq. 7): the
caller packs A once and replays the plan on it, so the model charges no
pack, the timed call runs on an A packed beforehand and only packed plans
compete (``autotuner.candidate_blocks``).

``gate`` picks the on-chip feasibility gate of the cost model
(``core/smem_model.py::feasible``): ``"vmem"`` charges the reference's
whole-block VMEM working set against ``vmem_bytes`` (a spec rebuilt from
the reference's fields gets it, so it ranks byte-identically); ``"launch"``
asks the CUDA wrappers' launch plans (``tall_plan``, ``skinny_plan``,
``pack_plan``) whether they take the plan's layout and charges their CTA
shared memory against ``vmem_bytes``.  ``launch_steps`` is what one extra
kernel launch costs, in ``grid_overhead_s`` steps: a ``loop=kouter`` point
makes one launch per k block (0 under the reference's fields, where the
k loop is one program).
"""

from __future__ import annotations

import dataclasses

MiB = 1024 * 1024


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops_bf16: float        # per chip
    hbm_bw: float                 # bytes/s per chip
    ici_bw_per_link: float        # bytes/s per link
    ici_links: int                # links per chip
    hbm_bytes: int                # capacity per chip
    vmem_bytes: int               # on-chip budget one kernel instance may plan into
    mxu_dim: int = 128            # matrix-unit tile edge
    sublane: dict = dataclasses.field(
        default_factory=lambda: {"float32": 8, "bfloat16": 16, "float64": 4}
    )
    # Calibration coefficients (fitted from measurements in a later slice;
    # the nominal spec keeps them at 1.0 and the max-roofline form).
    mxu_efficiency: float = 1.0
    hbm_efficiency: float = 1.0
    grid_overhead_s: float = 1.5e-7
    calibrated: bool = False
    sm_count: int = 0
    gate: str = "vmem"
    launch_steps: float = 0.0
    peak_flops_fp32: float = 0.0
    pack_once: bool = False

    @property
    def peak_flops_f32(self) -> float:
        return self.peak_flops_fp32 or self.peak_flops_bf16 / 4

    def peak_flops(self, dtype: str) -> float:
        return self.peak_flops_bf16 if dtype == "bfloat16" else self.peak_flops_f32


H100 = HwSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    ici_bw_per_link=25e9,
    ici_links=18,
    hbm_bytes=80 * 1000 ** 3,
    vmem_bytes=232_448,
    mxu_dim=64,
    sublane={"float32": 8, "bfloat16": 8, "float16": 8, "float64": 8},
    # one k-tile step of a CTA: a barrier round and address arithmetic.
    # An uncalibrated estimate; the measured install stage fits it.
    grid_overhead_s=5e-8,
    sm_count=132,
    gate="launch",
    # a launch from the eager host path costs ~20 us (PERF.md §6: the
    # k-outer point's 32 launches take 0.744 ms at GLM-4-9B's K/V shape),
    # 400 steps of 5e-8 s; calibration refits the step's cost
    launch_steps=400.0,
    # the data sheet's FP32 rate outside the tensor cores (SXM, 700 W):
    # the rate of the port's fp32 SIMT kernels
    peak_flops_fp32=67e12,
)

# Fraction of the on-chip budget the autotuner may plan into (the same
# margin the reference keeps for compiler scratch).
VMEM_USABLE_FRACTION = 0.75

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8, "int8": 1}


def dtype_bytes(dtype) -> int:
    return DTYPE_BYTES[dtype_name(dtype)]


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: the spelling problem keys use
    (identical to the reference's ``str(jnp.dtype)``)."""
    return str(dtype).removeprefix("torch.")


def for_device(device) -> HwSpec:
    """The planning spec for ``device``: on a CUDA device, the H100 spec
    with the SM count and the opt-in shared memory per block read from the
    device itself; on the CPU, the H100 data-sheet spec (so that CPU runs
    plan the same layouts the card does)."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return H100
    props = torch.cuda.get_device_properties(device)
    return dataclasses.replace(
        H100, name=props.name, sm_count=props.multi_processor_count,
        vmem_bytes=props.shared_memory_per_block_optin)
