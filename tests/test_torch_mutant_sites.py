"""Every fault ``chip_mutants.py`` plants, on the CPU: its site is found
exactly once in the part of its kernel's source it is planted in, and the
fault changes the source.  A site that drifts out of its source would
otherwise surface only on the card, as a mutation run that refuses to
start.  (Whether the smoke's gates catch each fault is ``chip_mutants.py``
's own check, on the card.)"""
import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "src/repro_torch/kernels/csrc"


def _mutants():
    spec = importlib.util.spec_from_file_location(
        "chip_mutants_sites", REPO / "chip_mutants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CM = _mutants()
FAULTS = [(k, n) for k, (muts, _) in CM.KERNELS.items() for n in muts]


def _source(kernel: str) -> str:
    src = (CSRC / f"{kernel}.cu").read_text()
    if kernel in CM.INLINED:
        head = CM.INLINED[kernel]
        src = src.replace(f'#include "{head}"\n',
                          (CSRC / head).read_text(), 1)
    return src


@pytest.mark.parametrize("kernel,name", FAULTS)
def test_fault_site_is_unique_and_changes_the_source(kernel, name):
    mutants, mark = CM.KERNELS[kernel]
    old, new, what = mutants[name]
    src = _source(kernel)
    out = CM.mutate(src, old, new, mark)
    assert out != src and what


def test_backward_kernels_keep_their_fault_counts():
    """At least the 7 and 5 faults of the first forms, one of K2b's in
    the cluster's fixed-order sum and one in the chunk-state indexing."""
    assert len(CM.K2B_MUTANTS) >= 7 and len(CM.K3B_MUTANTS) >= 5
    assert "cluster_rank_dropped" in CM.K2B_MUTANTS
    assert "dw_state_one_early" in CM.K2B_MUTANTS
