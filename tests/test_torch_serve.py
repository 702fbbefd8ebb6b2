"""The port's serving loop against the JAX package's, on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.serve.serve_step import Request as JaxRequest
from repro.serve.serve_step import ServingEngine as JaxServingEngine
from repro_torch.launch import serve as tlaunch
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.serve_step import Request, ServingEngine


def _cfg():
    return dataclasses.replace(jax_get_config("llama3.2-1b").reduced(),
                               n_kv_heads=2)


def _prompts(cfg, n, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, cfg.vocab_size, size=3 + i % 4) for i in range(n)]


def test_engine_tokens_identical_to_jax():
    """Same weights, same requests: the same greedy tokens.  Five requests
    on two slots exercise chunking, left-padding and ragged max_new."""
    cfg = _cfg()
    params, _ = jax_init_params(cfg, jax.random.PRNGKey(0))
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    prompts = _prompts(cfg, 5)
    max_new = [4, 6, 5, 4, 3]
    want = JaxServingEngine(cfg, params, slots=2, max_seq=16).run(
        [JaxRequest(i, p, m) for i, (p, m) in enumerate(zip(prompts,
                                                             max_new))])
    got = ServingEngine(cfg, model, slots=2, max_seq=16, device="cpu").run(
        [Request(i, p, m) for i, (p, m) in enumerate(zip(prompts, max_new))])
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        assert len(g.out) == g.max_new
        np.testing.assert_array_equal(g.out, np.asarray(w.out))


def test_engine_defaults_to_the_card():
    cfg = _cfg()
    model = tlaunch.init_params(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(cfg, model, slots=2, max_seq=16)


def test_engine_rejects_overlong_requests():
    cfg = _cfg()
    model = tlaunch.init_params(cfg, device="cpu")
    eng = ServingEngine(cfg, model, slots=2, max_seq=8, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        eng.run([Request(0, np.arange(5), 4)])


def test_throughput_report_keys():
    rep = tlaunch.throughput_report(_cfg(), 3, 12, 0.5)
    assert set(rep) == {"arch", "requests", "tokens", "wall_s", "tok_per_s"}
    assert rep["tok_per_s"] == 24.0 and rep["requests"] == 3


def test_launcher_serves_on_cpu(capsys):
    rep = tlaunch.main(["--device", "cpu", "--requests", "3",
                        "--max-new", "2", "--max-seq", "16"])
    assert rep["requests"] == 3 and rep["tokens"] == 6
    assert "tok_per_s" in capsys.readouterr().out


def test_launcher_serves_rwkv_on_cpu(capsys):
    rep = tlaunch.main(["--arch", "rwkv6-7b", "--device", "cpu",
                        "--requests", "2", "--max-new", "3",
                        "--max-seq", "16"])
    assert rep["arch"] == "rwkv6-7b-smoke"
    assert rep["requests"] == 2 and rep["tokens"] == 6
