"""The paper's own evaluation workload (§V): A is M×K = 25600×25600,
B is K×N with N swept over the skinny range; 200 repeated calls
(the data-reuse scenario).  Used by the paper's tools
(``launch/prepack_vs_conventional.py``, ``launch/packing_fraction.py``).

A copy of the reference package's ``configs/tsmm_paper.py``.  The port's
kernels take float32 and bfloat16, so the paper's DTSMM (float64) is
listed here as the reference lists it and not run.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class TSMMWorkload:
    M: int = 25600
    K: int = 25600
    n_sweep: tuple = (4, 8, 16, 32, 48, 64, 96, 128, 192, 240)
    repeats: int = 200
    dtypes: tuple = ("float32", "float64")   # STSMM / DTSMM in the paper


PAPER_WORKLOAD = TSMMWorkload()

# CPU-container-sized version of the same sweep (keeps ratios, shrinks M=K)
BENCH_WORKLOAD = TSMMWorkload(M=2048, K=2048, repeats=20,
                              dtypes=("float32",))
