"""The port's trainer, training CLI and serving from a trained checkpoint,
on the CPU.

The counterparts of ``tests/test_trainer.py`` (loss falls on Markov data,
exact resume, microbatch equivalence, recovery from a corrupt latest
checkpoint) on the same tiny config, then N steps of the port's
``Trainer`` from the reference's initial weights against N steps of the
reference ``Trainer`` for the three families' smoke configs in f32 (at the
resume test's rtol 1e-4, atol 1e-5), ``launch/train.py --device cpu
--scale smoke``, and ``launch/serve.py --ckpt-dir`` against serving the
trained model in memory.
"""

import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticLMSource as JSource
from repro.models import get_family as jfamily
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticLMSource
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import from_jax_params
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.server import Request, Server
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def _tiny_cfg():
    cfg = get_smoke_config("qwen1_5_0_5b")
    return dataclasses.replace(cfg, n_layers=2, d_model=32, n_heads=2,
                               n_kv_heads=2, head_dim=16, d_ff=64, vocab=64)


def _params(model):
    return [p.detach().float() for p in model.parameters()]


def test_loss_decreases_on_markov_data():
    cfg = _tiny_cfg()
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=0, branching=2)
    tcfg = TrainerConfig(adamw=AdamWConfig(lr=3e-3, weight_decay=0.01),
                         warmup=5, total_steps=60, ckpt_every=1000)
    trainer = Trainer(cfg, tcfg, device="cpu")
    trainer.fit(src, steps=60, resume=False)
    first = np.mean([m["loss"] for m in trainer.metrics_log[:5]])
    last = np.mean([m["loss"] for m in trainer.metrics_log[-5:]])
    # uniform-vocab entropy is ln(64) = 4.16; the branching-2 chain is ln(2)
    assert last < first - 0.5, (first, last)


def test_resume_exact(tmp_path):
    cfg = _tiny_cfg()
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=8, global_batch=4, seed=1)
    tcfg = TrainerConfig(ckpt_every=5, ckpt_dir=str(tmp_path / "ck"),
                         adamw=AdamWConfig(lr=1e-3), total_steps=100)
    m1, _ = Trainer(cfg, tcfg, device="cpu").fit(src, steps=10, resume=False)
    tcfg2 = dataclasses.replace(tcfg, ckpt_dir=str(tmp_path / "ck2"))
    Trainer(cfg, tcfg2, device="cpu").fit(src, steps=5, resume=False)
    t3 = Trainer(cfg, tcfg2, device="cpu")  # a new process, in effect
    m3, _ = t3.fit(src, steps=10, resume=True)
    assert t3.metrics_log[0]["step"] == 6  # resumed, not restarted
    for a, b in zip(_params(m1), _params(m3)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_microbatch_equivalence():
    """Accumulating over 4 microbatches equals one big batch (same data)."""
    cfg = _tiny_cfg()
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=8, global_batch=8, seed=2)
    batch = {k: torch.from_numpy(v).long() for k, v in src.batch_at(0).items()}
    t_one = Trainer(cfg, TrainerConfig(microbatches=1, adamw=AdamWConfig(lr=1e-3)), device="cpu")
    t_four = Trainer(cfg, TrainerConfig(microbatches=4, adamw=AdamWConfig(lr=1e-3)), device="cpu")
    p1, o1, _, m1 = t_one._step_fn(*t_one.init_state(3)[:2], batch, t_one.init_state(3)[2])
    p4, o4, _, m4 = t_four._step_fn(*t_four.init_state(3)[:2], batch, t_four.init_state(3)[2])
    np.testing.assert_allclose(m1["loss"].item(), m4["loss"].item(), rtol=1e-5)
    for a, b in zip(_params(p1), _params(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4, atol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        t_four._grads(p4, {k: v[:6] for k, v in batch.items()})


def test_recovery_from_corrupt_latest(tmp_path):
    cfg = _tiny_cfg()
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=8, global_batch=4, seed=1)
    t = Trainer(cfg, TrainerConfig(ckpt_every=3, ckpt_dir=str(tmp_path), total_steps=100),
                device="cpu")
    t.fit(src, steps=9, resume=False)
    newest = sorted(pathlib.Path(tmp_path).glob("ckpt_*"))[-1]
    (newest / "arrays.npz").write_bytes(b"junk")
    (model, opt_state, _), step, _ = t.recover(t.init_state(0))
    assert step == 6 and int(opt_state["step"]) == 6
    assert not any(torch.equal(a, b) for a, b in zip(_params(model), _params(t.init_state(0)[0]))
                   if a.abs().sum() > 0)


def test_compressed_dp_trains_on_a_stacked_mesh():
    """The path that raised while the DP step waited: 4 members on the
    host, a residual per member and reference leaf, member 0's loss."""
    from repro_torch.core.mesh import Mesh

    cfg = _tiny_cfg()
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=0, branching=2)
    t = Trainer(cfg, TrainerConfig(compress_grads=True, dp_axis="data", total_steps=10),
                mesh=Mesh((4,), ("data",), device="cpu"))
    t.fit(src, steps=2, resume=False)
    model, opt_state, err = t.state
    assert int(opt_state["step"]) == 2 and len(t.metrics_log) == 2
    assert err["blocks.*.attn.wq"].shape == (4, 2) + model.blocks[0].attn["wq"].shape
    assert not torch.equal(err["embed"][0], err["embed"][1])
    one = Trainer(cfg, TrainerConfig(), device="cpu")
    member0 = {k: torch.from_numpy(v[:2]).long() for k, v in src.batch_at(0).items()}
    loss0 = one.family.loss_fn(one.init_state(0)[0], member0, cfg)
    assert t.metrics_log[0]["loss"] == pytest.approx(loss0.item(), rel=1e-6)


def test_compressed_dp_needs_a_mesh():
    with pytest.raises(ValueError, match="pass mesh="):
        Trainer(_tiny_cfg(), TrainerConfig(compress_grads=True, dp_axis="data"), device="cpu")


def test_straggler_is_flagged():
    t = Trainer(_tiny_cfg(), TrainerConfig(straggler_factor=3.0), device="cpu")
    for step, dt in enumerate([1.0, 1.0, 1.0, 1.0, 1.0, 10.0, 1.0]):
        t._watch_straggler(dt, step)
    assert t.metrics_log == [{"step": 5, "straggler": 10.0}]


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "recurrentgemma_2b", "rwkv6_3b"])
def test_trainer_matches_reference_trainer(arch):
    """4 steps from the reference's initial weights, f32, one source."""
    jc, tc = jconfigs.get_smoke_config(arch), get_smoke_config(arch)
    kw = dict(vocab=jc.vocab, seq_len=16, global_batch=4, seed=1)
    ref_trainer = JTrainer(jc, JTrainerConfig(adamw=JAdamWConfig(lr=1e-3), warmup=2,
                                              total_steps=10))
    ref_params, _ = ref_trainer.fit(JSource(**kw), steps=4, resume=False)
    init = jfamily(jc).init(jax.random.PRNGKey(0), jc)
    model = from_jax_params(jax.tree.map(np.asarray, init), tc, "cpu")
    trainer = Trainer(tc, TrainerConfig(adamw=AdamWConfig(lr=1e-3), warmup=2, total_steps=10),
                      model=model)
    got, _ = trainer.fit(SyntheticLMSource(**kw), steps=4, resume=False)
    np.testing.assert_allclose([m["loss"] for m in trainer.metrics_log],
                               [m["loss"] for m in ref_trainer.metrics_log], rtol=1e-5)
    want = from_jax_params(jax.tree.map(np.asarray, ref_params), tc, "cpu")
    for (name, a), b in zip(got.named_parameters(), _params(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert not any(p.requires_grad for p in model.parameters())  # the given model is copied


def test_train_cli_smoke(capsys):
    trainer = ttrain.main(["--device", "cpu", "--scale", "smoke", "--steps", "4",
                           "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "arch=qwen1.5-0.5b family=transformer" in out and "device=the host CPU" in out
    assert "loss: first1=" in out and "steps=4" in out
    assert len(trainer.metrics_log) == 4
    assert all(np.isfinite(m["loss"]) for m in trainer.metrics_log)


@pytest.mark.parametrize("scale,arch", [("100m", "rwkv6_3b"), ("full", "qwen1_5_0_5b")])
def test_scaled_config(scale, arch):
    from repro.launch import train as jtrain

    got, want = ttrain.scaled_config(arch, scale), jtrain.scaled_config(arch, scale)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
              "loss_chunk", "remat"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "rwkv6_3b"])
def test_serve_from_a_trained_checkpoint(tmp_path, capsys, arch):
    ck = str(tmp_path / "ck")
    trainer = ttrain.main(["--device", "cpu", "--arch", arch, "--scale", "smoke", "--steps", "3",
                           "--batch", "2", "--seq", "16", "--lr", "3e-2", "--ckpt-dir", ck])
    trained = trainer.state[0]
    done = tserve.main(["--device", "cpu", "--arch", arch, "--ckpt-dir", ck, "--requests", "3",
                        "--max-new", "5"])
    assert "restored params from checkpoint @ step 3" in capsys.readouterr().out
    cfg = get_smoke_config(arch)
    server = Server(cfg, trained, max_len=8 + 5 + 1, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=[int(t) for t in rng.integers(0, cfg.vocab, 8)], max_new=5)
            for _ in range(3)]
    want = server.serve(reqs, batch_slots=4)
    assert [r.out for r in done] == [r.out for r in want]
    assert [r.prompt for r in done] == [r.prompt for r in want]


def test_serve_without_a_checkpoint_errors(tmp_path):
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--ckpt-dir", str(tmp_path / "none")])
