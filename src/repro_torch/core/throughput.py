"""Initial throughput estimation (paper Eq. 10) + the TPU re-parameterization.

    Throughput = PMI * batch_size * pcie_scaling
                 / (model_weight * dataset_size)

PMI (Performance-Memory Index) = tensor-core TFLOP/s divided by sqrt(VRAM
GB); model_weight scales {small, modest, high, extra-high} -> 1..4 and
dataset_size {S,M,L,XL} -> 1..4.  HadarE uses this to bootstrap scheduling
before any measured throughputs exist, then progressively replaces the
estimates with per-round measurements (paper §V-A).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

# (tensor TFLOP/s, VRAM GB, interconnect scaling).  Interconnect scaling is
# the Eq. 10 pcie term for GPUs; for TPUs it models the ICI generation.
DEVICE_SPECS: Dict[str, Dict[str, float]] = {
    "v100":     {"tflops": 125.0, "vram": 16.0},
    "p100":     {"tflops": 18.7, "vram": 16.0},
    "k80":      {"tflops": 5.6, "vram": 12.0},
    "t4":       {"tflops": 65.0, "vram": 16.0},
    "titanrtx": {"tflops": 130.0, "vram": 24.0},
    "rtx3090":  {"tflops": 142.0, "vram": 24.0},
    "t400":     {"tflops": 1.1, "vram": 4.0},
    "a2000":    {"tflops": 63.9, "vram": 6.0},
    # TPU generations (the hardware-adaptation targets)
    "tpu-v4":   {"tflops": 275.0, "vram": 32.0},
    "tpu-v5e":  {"tflops": 197.0, "vram": 16.0},
    "tpu-v5p":  {"tflops": 459.0, "vram": 95.0},
}

MODEL_WEIGHT = {"small": 1.0, "modest": 2.0, "high": 3.0, "extra": 4.0}
DATASET_SIZE = {"S": 1.0, "M": 2.0, "L": 3.0, "XL": 4.0}

# per-model complexity class (paper Table II/III workloads)
MODEL_CLASS = {
    "resnet18": "small", "lstm": "modest", "mima": "modest",
    "transformer": "high", "recorder": "high", "resnet50": "extra",
    "cyclegan": "extra", "a3c": "small",
}


def pmi(device: str) -> float:
    s = DEVICE_SPECS[device]
    return s["tflops"] / math.sqrt(s["vram"])


def estimate_throughput(model: str, device: str, batch_size: int = 32,
                        pcie_scaling: float = 1.0,
                        dataset: Optional[str] = None) -> float:
    """Eq. 10 — iterations/sec estimate before any profiling."""
    w = MODEL_WEIGHT[MODEL_CLASS.get(model, "modest")]
    d = DATASET_SIZE[dataset or "M"]
    return pmi(device) * batch_size * pcie_scaling / (w * d * 1000.0)


def estimate_table(models, devices, batch_size: int = 32,
                   pcie: Optional[Dict[str, float]] = None):
    pcie = pcie or {}
    return {m: {r: estimate_throughput(m, r, batch_size,
                                       pcie.get(r, 1.0))
                for r in devices} for m in models}


class ThroughputTracker:
    """Progressive refinement: starts with Eq. 10 estimates, replaces each
    (model, device) cell with an EWMA of measured iterations/sec as rounds
    report back (paper §V-A 'quality of throughput information is improved
    progressively')."""

    def __init__(self, models, devices, batch_size: int = 32,
                 pcie: Optional[Dict[str, float]] = None,
                 ewma: float = 0.5):
        self.table = estimate_table(models, devices, batch_size, pcie)
        self.measured: Dict = {}
        self.ewma = ewma

    def get(self, model: str, device: str) -> float:
        return self.table[model][device]

    def observe(self, model: str, device: str, iters_per_sec: float) -> None:
        old = self.measured.get((model, device))
        new = (iters_per_sec if old is None
               else self.ewma * iters_per_sec + (1 - self.ewma) * old)
        self.measured[(model, device)] = new
        self.table[model][device] = new

    def coverage(self) -> float:
        cells = sum(len(v) for v in self.table.values())
        return len(self.measured) / max(1, cells)
