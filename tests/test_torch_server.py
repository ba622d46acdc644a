"""The port's serving loop against the JAX reference's, on the CPU.

The config of tests/test_server.py, the JAX parameters from ``PRNGKey(0)``
carried across by ``from_jax_params``: prefill and decode logits agree at
2e-4 in f32, and ``generate`` / ``serve`` give the same greedy tokens (and
the same sampled tokens at a temperature, from the same numpy seed).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.models import get_family as jfamily
from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import from_jax_params
from repro_torch.runtime.server import Request, Server

SMALL = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, vocab=64)


def _servers(max_len=32, temperature=0.0):
    jc = dataclasses.replace(jsmoke("qwen1_5_0_5b"), **SMALL)
    tc = dataclasses.replace(tsmoke("qwen1_5_0_5b"), **SMALL)
    params = jfamily(jc).init(jax.random.PRNGKey(0), jc)
    model = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu")
    return (JServer(jc, params, max_len=max_len, temperature=temperature),
            Server(tc, model, max_len=max_len, temperature=temperature, device="cpu"))


def test_server_logits_match_jax():
    js, ts = _servers()
    prompts = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]])
    jlogits, jcache = js._prefill(js.params, prompts.astype(np.int32))
    with torch.inference_mode():
        tlogits, tcache = ts._prefill(torch.from_numpy(prompts))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)
    nxt = np.asarray([[9], [10]])
    jlogits, _ = js._decode(js.params, jcache, nxt.astype(np.int32), 4)
    with torch.inference_mode():
        tlogits, _ = ts._decode(tcache, torch.from_numpy(nxt), 4)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=2e-4, atol=2e-4)


def test_generate_matches_jax():
    js, ts = _servers()
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8]]
    out = ts.generate(prompts, max_new=6)
    assert out == js.generate(prompts, max_new=6)
    assert out == ts.generate(prompts, max_new=6)  # deterministic
    assert all(len(o) == 6 and all(0 <= t < ts.cfg.vocab for t in o) for o in out)


def test_generate_with_temperature_matches_jax():
    js, ts = _servers(temperature=0.7)
    prompts = [[3, 1, 4, 1], [5, 9, 2, 6]]
    assert ts.generate(prompts, max_new=5, seed=4) == js.generate(prompts, max_new=5, seed=4)


def test_serve_matches_jax_with_ragged_prompts():
    """Waves left-pad to their longest prompt with token 0, as the reference."""
    js, ts = _servers()
    prompts = [[i + 1, i + 2, i + 3][: 1 + i % 3] for i in range(7)]
    treqs = ts.serve([Request(prompt=p, max_new=3 + i % 2) for i, p in enumerate(prompts)],
                     batch_slots=3)
    jreqs = js.serve([JRequest(prompt=p, max_new=3 + i % 2) for i, p in enumerate(prompts)],
                     batch_slots=3)
    assert all(r.done for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]


def test_server_checks_its_arguments():
    _, ts = _servers(max_len=8)
    with pytest.raises(ValueError, match="same length"):
        ts.generate([[1, 2], [3]], max_new=2)
    with pytest.raises(ValueError, match="max_len"):
        ts.generate([[1, 2, 3, 4]], max_new=6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Server(ts.cfg, ts.model)


def test_serve_cli_runs_on_the_host(capsys):
    done = tserve.main(["--device", "cpu", "--arch", "gemma3_12b", "--requests", "3",
                        "--max-new", "4", "--batch-slots", "2"])
    assert len(done) == 3 and all(r.done and len(r.out) == 4 for r in done)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--ckpt-dir", "somewhere"])
