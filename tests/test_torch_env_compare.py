"""The port's policy-comparison harness (``repro_torch.env.compare``)
against the JAX package's (``repro.env.compare``), on the CPU.

The whole quality table of the default policies on the fig5 reference
trace equals the reference's, document for document, in event mode, in
round mode and under a failure model; so does its rendering and the
CLI's JSON.  A table from either package validates with either
validator; the negative cases of ``validate_table``; trace-reuse
isolation; the device rule: ``compare``, ``run_one`` and the CLI raise
without CUDA unless the caller asks for the CPU.  Hadar and HadarE run
in both packages with ``solver="numpy"``, and once on the port's batched
path (``solver="cuda", device="cpu"``: the kernels' plain versions).
"""
import copy
import json

import pytest
import torch

# `from repro.env import compare` would recurse in the JAX package's lazy
# __getattr__ before the submodule is imported; importing it by its full
# name does not
import repro.env.compare as jcmp
import repro_torch.env.compare as tcmp
from repro.core import trace as jtrace
from repro.sim import faults as jfaults
from repro_torch.core import trace as ttrace
from repro_torch.sim import faults as tfaults
from repro_torch.sim.metrics import result_fields

MODEL = dict(seed=7, mtbf_hours=24.0, spot_frac=0.2, spot_reclaim_hours=8.0)
CASES = {"event": dict(mode="event"), "round": dict(mode="round"),
         "faulted": dict(mode="event", faults=True)}


@pytest.fixture(scope="module")
def table():
    """``table(side, case)``: the default policies' table on
    fig5(n=16, seed=0) from one package (0 the reference, 1 the port),
    built once per module."""
    built = {}

    def get(side, case):
        if (side, case) not in built:
            tr, cmp, F = ((jtrace, jcmp, jfaults),
                          (ttrace, tcmp, tfaults))[side]
            kw = dict(CASES[case])
            if kw.pop("faults", False):
                kw["faults"] = F.FailureModel(**MODEL)
            if side:
                kw["device"] = "cpu"
            built[side, case] = cmp.compare(
                tr.philly_trace(n_jobs=16, seed=0), tr.simulation_cluster(),
                policies=cmp.DEFAULT_POLICIES, solver="numpy",
                trace_name="fig5(n=16, seed=0)", **kw)
        return built[side, case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_compare_document_matches_jax_package(table, case):
    want, got = table(0, case), table(1, case)
    assert got == want
    assert got["schema"] == jcmp.TABLE_SCHEMA == tcmp.TABLE_SCHEMA
    assert tcmp.validate_table(got) == [] and jcmp.validate_table(got) == []
    assert tcmp.render_table(got) == jcmp.render_table(want)
    assert [r["policy"] for r in got["policies"]] == \
        list(tcmp.DEFAULT_POLICIES)
    if case == "faulted":
        assert got["faulted"] and any(r["evictions"]
                                      for r in got["policies"])


def test_compare_on_the_batched_path_matches_jax_package():
    """Hadar and HadarE through the port's batched path on the CPU (the
    kernels' plain versions) give the reference's NumPy rows."""
    want = jcmp.compare(jtrace.philly_trace(n_jobs=8, seed=2),
                        jtrace.simulation_cluster(), ("hadar", "hadare"),
                        solver="numpy")
    got = tcmp.compare(ttrace.philly_trace(n_jobs=8, seed=2),
                       ttrace.simulation_cluster(), ("hadar", "hadare"),
                       solver="cuda", device="cpu")
    assert got == want


def test_module_tables_and_names_match_jax_package():
    assert tcmp.DEFAULT_POLICIES == jcmp.DEFAULT_POLICIES
    assert tcmp.BLIND_POLICIES == jcmp.BLIND_POLICIES
    assert sorted(tcmp.POLICIES) == sorted(jcmp.POLICIES)
    for name, make in tcmp.POLICIES.items():
        if make is not None:
            assert make().name == jcmp.POLICIES[name]().name


def test_hadar_ttd_beats_every_blind_baseline(table):
    rows = {r["policy"]: r for r in table(1, "event")["policies"]}
    hadar = rows["hadar"]
    assert hadar["completed"] == hadar["n_jobs"]
    blind = [p for p in tcmp.BLIND_POLICIES if p in rows]
    assert len(blind) == 6
    for p in blind:
        assert hadar["ttd_hours"] <= rows[p]["ttd_hours"] + 1e-9, p


# ---------------------------------------------------------------------------
# schema validation
# ---------------------------------------------------------------------------

def test_validate_table_rejects_corruptions(table):
    ok = table(1, "event")
    assert tcmp.validate_table(ok) == []
    assert tcmp.validate_table([]) == ["table is not an object"]

    def bad(edit):
        doc = copy.deepcopy(ok)
        edit(doc)
        probs = tcmp.validate_table(doc)
        assert probs == jcmp.validate_table(doc)
        return probs

    assert any("schema" in p for p in bad(
        lambda d: d.update(schema="something/else")))
    assert any("round_len" in p for p in bad(lambda d: d.pop("round_len")))
    assert any("non-empty" in p for p in bad(
        lambda d: d.update(policies=[])))
    assert any("missing 'gru'" in p for p in bad(
        lambda d: d["policies"][0].pop("gru")))
    assert any("ttd_hours" in p for p in bad(
        lambda d: d["policies"][0].update(ttd_hours="fast")))
    assert any("evictions" in p for p in bad(
        lambda d: d["policies"][0].update(evictions=True)))
    assert any("out of [0, 1]" in p for p in bad(
        lambda d: d["policies"][0].update(gru=1.5)))
    assert any("goodput" in p for p in bad(
        lambda d: d["policies"][0].update(
            goodput=d["policies"][0]["gru_overall"] + 1.0)))
    assert any("negative" in p for p in bad(
        lambda d: d["policies"][0].update(avg_jct_s=-1.0)))
    assert any("duplicate" in p for p in bad(
        lambda d: d["policies"].append(dict(d["policies"][0]))))


# ---------------------------------------------------------------------------
# trace reuse: no state leaks between runs
# ---------------------------------------------------------------------------

def _snapshot(jobs):
    return [(j.job_id, j.done_iters, j.finish_time, j.attained_service,
             j.alloc, j.restarts, j.evictions, j.lost_iters) for j in jobs]


def test_runs_leave_inputs_pristine_and_own_their_jobs():
    cluster = ttrace.simulation_cluster()
    jobs = ttrace.philly_trace(n_jobs=8, seed=0)
    before = _snapshot(jobs)
    first = tcmp.run_one("fcfs", jobs, cluster, device="cpu")
    fins = [j.finish_time for j in first.jobs]
    tcmp.run_one("srtf", jobs, cluster, device="cpu")
    tcmp.run_one("hadar", jobs, cluster, solver="numpy", device="cpu")
    again = tcmp.run_one("fcfs", jobs, cluster, device="cpu")
    fresh = tcmp.run_one("fcfs", ttrace.philly_trace(n_jobs=8, seed=0),
                         cluster, device="cpu")
    assert _snapshot(jobs) == before
    assert [j.finish_time for j in first.jobs] == fins
    assert all(rj is not tj for rj in first.jobs for tj in jobs)
    assert result_fields(again) == result_fields(first) \
        == result_fields(fresh)
    with pytest.raises(ValueError, match="unknown policy"):
        tcmp.run_one("lottery", jobs, cluster, device="cpu")


# ---------------------------------------------------------------------------
# CLI and the device rule
# ---------------------------------------------------------------------------

def test_cli_json_matches_jax_package(tmp_path, capsys):
    args = ["--fig5", "8", "--seed", "3", "--policies", "fcfs,srtf,hadar",
            "--solver", "numpy"]
    assert jcmp.main(args + ["--json", str(tmp_path / "want.json")]) == 0
    want_text = capsys.readouterr().out
    assert tcmp.main(args + ["--device", "cpu",
                             "--json", str(tmp_path / "got.json")]) == 0
    got_text = capsys.readouterr().out
    want = json.loads((tmp_path / "want.json").read_text())
    got = json.loads((tmp_path / "got.json").read_text())
    assert got == want and tcmp.validate_table(got) == []
    assert [r["policy"] for r in got["policies"]] == ["fcfs", "srtf",
                                                      "hadar"]
    assert got_text.replace("got.json", "want.json") == want_text
    with pytest.raises(ValueError, match="unknown policy"):
        tcmp.main(["--device", "cpu", "--fig5", "4",
                   "--policies", "fcfs,nope"])


def test_entry_points_need_cuda_unless_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster = ttrace.simulation_cluster()
    jobs = ttrace.philly_trace(n_jobs=2, seed=0)
    for call in (lambda: tcmp.compare(jobs, cluster, ("fcfs",)),
                 lambda: tcmp.run_one("fcfs", jobs, cluster),
                 lambda: tcmp.run_one("hadar", jobs, cluster,
                                      solver="numpy"),
                 lambda: tcmp.main(["--fig5", "2", "--policies", "fcfs"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    doc = tcmp.compare(jobs, cluster, ("fcfs",), device="cpu")
    assert tcmp.validate_table(doc) == []
    assert tcmp.main(["--device", "cpu", "--fig5", "2",
                      "--policies", "fcfs"]) == 0
    assert "fcfs" in capsys.readouterr().out
