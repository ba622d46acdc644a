"""The port's transformers against the JAX reference, on the CPU.

For the smoke config of each of the seven transformers (the MoE ones,
phi3.5-moe and moonshot, and the dense yi, qwen, glm4, gemma3,
chameleon): the JAX parameters from ``PRNGKey(0)`` are
carried across by ``from_jax_params``, and ``forward`` (hidden states),
``prefill`` (logits and cache) and ``decode_step`` (logits and cache) are
held against the reference in f32 at 2e-4.  The smoke configs cover
gemma3's local:global windows, qwen's QKV biases and tied embeddings, and
GQA with 1 and 2 kv heads.  The MoE configs' decode-after-prefill gate
runs at the reference test's ``capacity_factor=64``: capacity drops
legitimately differ between a prefill batch and a decode batch.
"""

import dataclasses


import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_family as jfamily
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as tt
from repro_torch.models.convert import from_jax_params

TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 16


DENSE = [a for a in tconfigs.ARCH_IDS if tconfigs.get_config(a).family == "transformer"]


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    arch = request.param
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jfam = jfamily(jc)
    params = jfam.init(jax.random.PRNGKey(0), jc)
    model = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu")
    tokens = np.random.default_rng(2).integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
    return arch, jc, tc, jfam, params, model, tokens


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tok(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def test_forward_matches_jax(pair):
    _, jc, tc, jfam, params, model, tokens = pair
    hidden, aux = tt.forward(model, _tok(tokens[:, :S]), tc)
    jhidden, jaux = jax.jit(lambda p, t: jfam.forward(p, t, jc))(params, tokens[:, :S])
    assert hidden.shape == (B, S, jc.d_model) and (float(aux) > 0) == bool(tc.n_experts)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(_np(hidden), _np(jhidden), **TOL)
    np.testing.assert_allclose(_np(model(_tok(tokens[:, :S]))[0]), _np(jhidden), **TOL)


def test_prefill_and_decode_match_jax(pair):
    _, jc, tc, jfam, params, model, tokens = pair
    logits, cache = tt.prefill(model, _tok(tokens[:, :S]), tc, max_len=S + 1)
    jlogits, jcache = jax.jit(lambda p, t: jfam.prefill(p, t, jc, max_len=S + 1))(
        params, tokens[:, :S])
    assert logits.shape == (B, jc.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    np.testing.assert_allclose(_np(cache.k), _np(jcache.k), **TOL)
    np.testing.assert_allclose(_np(cache.v), _np(jcache.v), **TOL)

    dlogits, dcache = tt.decode_step(model, cache, _tok(tokens[:, S:]), S, tc)
    jdlogits, jdcache = jax.jit(lambda p, c, t: jfam.decode_step(p, c, t, S, jc))(
        params, jcache, tokens[:, S:])
    np.testing.assert_allclose(_np(dlogits), _np(jdlogits), **TOL)
    np.testing.assert_allclose(_np(dcache.k), _np(jdcache.k), **TOL)
    np.testing.assert_allclose(_np(dcache.v), _np(jdcache.v), **TOL)


def test_prefill_decode_consistency(pair):
    """decode(prefill(x[:S]), x[S]) matches prefill(x[:S+1]): the KV-cache gate
    of tests/test_arch_smoke.py, on the port alone."""
    _, _, tc, _, _, model, tokens = pair
    if tc.n_experts:
        tc = dataclasses.replace(tc, capacity_factor=64.0)
    full, _ = tt.prefill(model, _tok(tokens), tc, max_len=S + 1)
    _, cache = tt.prefill(model, _tok(tokens[:, :S]), tc, max_len=S + 1)
    dec, _ = tt.decode_step(model, cache, _tok(tokens[:, S:]), S, tc)
    np.testing.assert_allclose(_np(dec), _np(full), **TOL)
