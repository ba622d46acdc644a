"""Sharded serving of the recurrentgemma hybrid, rwkv6 and whisper, on the CPU.

For each of the three smoke configs the JAX parameters from ``PRNGKey(0)``
are carried across by ``from_jax_params`` and laid out on a stacked
``(2, 4)`` ``("data", "model")`` mesh by ``shard_model`` under
``make_policy``, with sequence parallelism off and on.  The sharded
``prefill`` (logits, and the cache read back to global arrays through the
family's ``cache_spec``: the hybrid's ``rec_h``, ``conv`` and attention k /
v, rwkv6's ``state`` and ``shift``, whisper's self-attention k / v and
``memory``) and a ``decode_step`` after it (its logits and the cache it
leaves) are held at 2e-4 against the reference's own sharded run:
``jax.jit`` of its ``prefill`` and ``decode_step`` with the policy, under
``jax.set_mesh`` on 8 spoofed XLA host devices in a subprocess
(``XLA_FLAGS`` is set before JAX loads), its parameters placed with
``NamedSharding`` by its ``param_specs``.  The same passes and ``forward``
(``encode`` for whisper) are held at 2e-4 against the port's own unsharded
model on the ``(2, 4)`` and the ``(1, 4)`` mesh.  ``Server(policy=,
mesh=)`` serves the hybrid and rwkv6 the reference ``Server``'s tokens
under the mesh.  The hybrid's prompts are 16 tokens, two of its smoke
window of 8, and its served prompts at most 8: the reference's prefill
fills the rolling cache right only then (``models/rglru.py``).
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_family as jfamily
from repro_torch import configs as tconfigs
from repro_torch.core import mesh as M
from repro_torch.launch.steps import make_policy
from repro_torch.models import get_family
from repro_torch.models.convert import from_jax_params, shard_model
from repro_torch.runtime.server import Request, Server

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-4, atol=2e-4)
NAMES = ("data", "model")
B, S = 4, 16
ARCHS = ("recurrentgemma_2b", "rwkv6_3b", "whisper_base")
SERVED = ("recurrentgemma_2b", "rwkv6_3b")
MAX_LEN, MAX_NEW = 24, 6
PROMPT_LENS = (5, 8, 3, 7, 6, 4)  # two waves over 4 slots, each at most the window of 8

REFERENCE = r"""
import os, sys, json
# a device thread starved by a loaded host must not abort the run at the
# collectives' default 40 s rendezvous deadline
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_collective_call_terminate_timeout_seconds=900")
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.launch.steps import make_policy
from repro.models import get_family
from repro.runtime.server import Request, Server

inp = dict(np.load(sys.argv[1]))
archs, served, max_len, max_new = json.loads(sys.argv[3])
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}

def cache_leaves(prefix, cache):
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

for arch in archs:
    jc = configs.get_smoke_config(arch)
    fam = get_family(jc)
    params = fam.init(jax.random.PRNGKey(0), jc)
    tokens = inp["tokens"]
    S = tokens.shape[1] - 1
    batch = tokens[:, :S] if jc.family != "whisper" else {
        "frames": inp[f"{arch}/frames"], "tokens": tokens[:, :S]}
    for sp in (False, True):
        pol = make_policy(jc, mesh, seq_parallel=sp)
        key = f"{arch} sp={sp}"
        with jax.set_mesh(mesh):
            placed = jax.tree.map(lambda s, a: jax.device_put(a, NamedSharding(mesh, s)),
                                  fam.param_specs(jc, pol), params,
                                  is_leaf=lambda x: isinstance(x, P))
            logits, cache = jax.jit(lambda p, t: fam.prefill(p, t, jc, pol, max_len=S + 1))(
                placed, batch)
            cache_leaves(f"{key}/cache", cache)
            dlogits, dcache = jax.jit(lambda p, c, t: fam.decode_step(p, c, t, S, jc, pol))(
                placed, cache, tokens[:, S:])
            cache_leaves(f"{key}/dcache", dcache)
            out[f"{key}/logits"], out[f"{key}/dlogits"] = np.asarray(logits), np.asarray(dlogits)
            if arch in served and not sp:
                reqs = [Request(prompt=[int(t) for t in p[p >= 0]], max_new=max_new)
                        for p in inp["prompts"]]
                done = Server(jc, placed, max_len=max_len, policy=pol).serve(reqs, batch_slots=4)
                out[f"{arch}/served"] = np.array([r.out for r in done])
np.savez(sys.argv[2], **out)
print("REFERENCE OK")
"""


def _prompts():
    rng = np.random.default_rng(5)
    out = np.full((len(PROMPT_LENS), max(PROMPT_LENS)), -1, np.int64)
    for i, n in enumerate(PROMPT_LENS):
        out[i, :n] = rng.integers(0, 256, n)
    return out


def _frames(arch: str) -> np.ndarray:
    cfg = tconfigs.get_smoke_config(arch)
    rng = np.random.default_rng(ARCHS.index(arch) + 30)
    return rng.standard_normal((B, cfg.encoder_len, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_families")
    tokens = np.random.default_rng(2).integers(0, 256, (B, S + 1)).astype(np.int32)
    np.savez(d / "in.npz", tokens=tokens, prompts=_prompts(),
             **{"whisper_base/frames": _frames("whisper_base")})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "in.npz"), str(d / "out.npz"),
                           json.dumps([ARCHS, SERVED, MAX_LEN, MAX_NEW])],
                          capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert "REFERENCE OK" in proc.stdout, proc.stderr[-3000:]
    return tokens, dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module", params=ARCHS)
def unsharded(request):
    """(arch, config, the port's model with the reference's weights)."""
    arch = request.param
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    params = jfamily(jc).init(jax.random.PRNGKey(0), jc)
    return arch, tc, from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu")


def _sharded(model, cfg, shape=(2, 4), seq_parallel=False):
    mesh = M.Mesh(shape, NAMES, device="cpu")
    policy = make_policy(cfg, mesh, seq_parallel=seq_parallel)
    return shard_model(copy.deepcopy(model), mesh, policy), mesh, policy


def _tok(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def _batch(arch, cfg, tokens):
    if cfg.family != "whisper":
        return tokens
    return {"frames": torch.from_numpy(_frames(arch)), "tokens": tokens}


def _cache_leaves(cache, mesh, spec) -> dict:
    """The cache's global arrays (``mesh`` None: an unsharded cache) by the
    reference's ``keystr`` paths: a NamedTuple's fields as ``.name``, a
    list's entries as ``[i]``."""
    out = {}

    def walk(path, node, spec_node):
        if node is None:
            return
        if isinstance(node, torch.Tensor):
            out[path] = (node if mesh is None else M.unshard(node, mesh, spec_node)).clone()
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for name in node._fields:
                walk(f"{path}.{name}", getattr(node, name), getattr(spec_node, name))
        else:
            for i, (n, s) in enumerate(zip(node, spec_node)):
                walk(f"{path}[{i}]", n, s)

    walk("", cache, spec)
    return out


def _close(got, want, name, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=name, **tol)


@pytest.mark.parametrize("seq_parallel", [False, True], ids=["sp=False", "sp=True"])
def test_sharded_prefill_cache_and_decode_match_the_reference(reference, unsharded,
                                                              seq_parallel):
    tokens, ref = reference
    arch, tc, model = unsharded
    fam = get_family(tc)
    sharded, mesh, policy = _sharded(model, tc, seq_parallel=seq_parallel)
    key = f"{arch} sp={seq_parallel}"
    spec = fam.cache_spec(tc, policy)
    logits, cache = fam.prefill(sharded, _batch(arch, tc, _tok(tokens[:, :S])), tc, policy,
                                max_len=S + 1)
    assert logits.shape == (B, tc.padded_vocab) and logits.dtype == torch.float32
    _close(logits.numpy(), ref[f"{key}/logits"], "logits")
    got = _cache_leaves(cache, mesh, spec)
    want = {k[len(f"{key}/cache"):]: v for k, v in ref.items() if k.startswith(f"{key}/cache")}
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        assert tuple(g.shape) == want[path].shape, path
        _close(g.numpy(), want[path], f"prefill cache{path}")
    dlogits, cache = fam.decode_step(sharded, cache, _tok(tokens[:, S:]), S, tc, policy)
    _close(dlogits.numpy(), ref[f"{key}/dlogits"], "decode logits")
    for path, g in _cache_leaves(cache, mesh, spec).items():
        _close(g.numpy(), ref[f"{key}/dcache{path}"], f"decode cache{path}")


@pytest.mark.parametrize("seq_parallel", [False, True], ids=["sp=False", "sp=True"])
@pytest.mark.parametrize("shape", [(2, 4), (1, 4)], ids=["mesh(2,4)", "mesh(1,4)"])
def test_sharded_passes_match_the_unsharded_model(unsharded, shape, seq_parallel):
    """Same weights, same tokens: prefill, its cache, the decode after it
    and forward (whisper: encode) within 2e-4 of the port's unsharded model."""
    arch, tc, model = unsharded
    fam = get_family(tc)
    sharded, mesh, policy = _sharded(model, tc, shape, seq_parallel)
    tokens = _tok(np.random.default_rng(4).integers(0, tc.vocab, (B, S + 1)))
    want, cache = fam.prefill(model, _batch(arch, tc, tokens[:, :S]), tc, max_len=S + 1)
    got, scache = fam.prefill(sharded, _batch(arch, tc, tokens[:, :S]), tc, policy,
                              max_len=S + 1)
    _close(got.numpy(), want.numpy(), "prefill logits")
    want_cache = _cache_leaves(cache, None, fam.cache_spec(tc, make_policy(tc, mesh)))
    for path, g in _cache_leaves(scache, mesh, fam.cache_spec(tc, policy)).items():
        _close(g.numpy(), want_cache[path].numpy(), f"cache{path}")
    want = fam.decode_step(model, cache, tokens[:, S:], S, tc)[0]
    got = fam.decode_step(sharded, scache, tokens[:, S:], S, tc, policy)[0]
    _close(got.numpy(), want.numpy(), "decode logits")
    if tc.family == "whisper":
        frames = _batch(arch, tc, None)["frames"]
        _close(fam.encode(sharded, frames, tc, policy).numpy(),
               fam.encode(model, frames, tc).numpy(), "encode")
    else:
        hidden, aux = fam.forward(sharded, tokens[:, :S], tc, policy)
        _close(hidden.numpy(), fam.forward(model, tokens[:, :S], tc)[0].numpy(), "forward")
        assert aux.shape == () and float(aux) == 0.0


def test_sharded_cache_layout_follows_the_spec(unsharded):
    """Each cache entry is laid out as ``cache_spec`` says: the hybrid's
    states on the LRU width and its attention cache on head_dim (its one
    kv head), rwkv6's state and shift and whisper's memory whole on each
    model member, whisper's self-attention cache on its kv heads."""
    arch, tc, model = unsharded
    fam = get_family(tc)
    sharded, mesh, policy = _sharded(model, tc)
    _, cache = fam.prefill(sharded, _batch(arch, tc, torch.zeros((B, S), dtype=torch.int64)),
                           tc, policy)
    lead, b = (2, 4), B // 2
    if tc.family == "rglru_hybrid":
        w, window = tc.lru_width // 4, tc.attn_window
        rec = [i for i, h in enumerate(cache.rec_h) if h is not None]
        att = [i for i, a in enumerate(cache.attn) if a is not None]
        assert rec and att
        for i in rec:
            assert tuple(cache.rec_h[i].shape) == lead + (b, w)
            assert tuple(cache.conv[i].shape) == lead + (b, tc.conv_width - 1, w)
        for i in att:
            assert tuple(cache.attn[i].k.shape) == lead + (b, window, 1, tc.head_dim // 4)
    elif tc.family == "rwkv6":
        hd = tc.rwkv_head_size
        assert tuple(cache.state.shape) == lead + (tc.n_layers, b, tc.d_model // hd, hd, hd)
        assert tuple(cache.shift.shape) == lead + (tc.n_layers, b, 2, tc.d_model)
    else:
        assert tuple(cache.self_kv.k.shape) == lead + (tc.n_layers, b, S, tc.n_kv_heads // 4,
                                                       tc.head_dim)
        assert tuple(cache.memory.shape) == lead + (b, tc.encoder_len, tc.d_model)


@pytest.mark.parametrize("arch", SERVED)
def test_server_under_a_mesh_serves_the_reference_tokens(reference, arch):
    _, ref = reference
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    model = from_jax_params(jax.tree.map(np.asarray, jfamily(jc).init(jax.random.PRNGKey(0), jc)),
                            tc, "cpu")
    mesh = M.Mesh((2, 4), NAMES, device="cpu")
    server = Server(tc, model, max_len=MAX_LEN, device="cpu", policy=make_policy(tc, mesh),
                    mesh=mesh)
    assert model.mesh is mesh
    reqs = [Request(prompt=[int(t) for t in p[p >= 0]], max_new=MAX_NEW) for p in _prompts()]
    done = server.serve(reqs, batch_slots=4)
    assert [r.out for r in done] == ref[f"{arch}/served"].tolist()
