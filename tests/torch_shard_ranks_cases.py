"""The checks of the port's sharded language models on four gloo CPU ranks,
shared by ``tests/test_torch_shard_ranks*.py`` (three files, so that each
file's one spawn stays short: ``--dist loadfile`` gives a file one worker).

Each file's archs draw their reduced weights through the JAX package
(float32) and bridge them; every arch's prefill logits and loss, with its
parameters and batch placed by ``repro_torch.models.sharding`` over a
(2, 2) and a (1, 4) DeviceMesh, are held against the unsharded port on the
same weights within ``REL`` of max |logit| (of the loss), and so are one
decode step's logits and caches from zeroed caches (every arch but the
encoder-decoder, whose step takes the encoder's cross K/V).  A train arch
also runs ``value_and_grad`` (its gradients within ``REL`` of each leaf's
max |g|) and one ``make_train_step`` step, whose parameters and moments
equal AdamW applied unsharded to the sharded gradients within ``REL`` of
each leaf's max: Adam's first step divides g by |g| + eps, which turns a
gradient's error far below ``REL`` of its leaf's max into a step that
differs by a large share of the learning rate where |g| is near eps."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs
from repro_torch.launch import dist_index as di
from repro_torch.models import model as M
from repro_torch.models import sharding as shd
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state
from repro_torch.train.train_loop import value_and_grad

MESHES = ((2, 2), (1, 4))
OPT = OptConfig(lr=1e-3, warmup_steps=1)
REL = 1e-5
DECODE_CACHE, DECODE_POS = 8, 3


def batch(cfg, b=4, s=16):
    out = {"tokens": np.random.default_rng(0).integers(1, cfg.vocab, (b, s)).astype(np.int32),
           "labels": np.random.default_rng(1).integers(1, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend or cfg.kind == "encdec":
        out["frontend"] = np.random.default_rng(2).normal(
            0, 0.02, (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def decode_batch(cfg, b=4):
    return {"tokens": torch.from_numpy(
        np.random.default_rng(4).integers(1, cfg.vocab, (b, 1)).astype(np.int32))}


def bridged_params(arch):
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jconfigs.get_reduced(arch))
    return bridge.lm_params_from_numpy(configs.get_reduced(arch),
                                       jax.tree.map(np.asarray, jp))


def spawn(archs, train_archs):
    """{arch: (cfg, params, batch, runs, every rank's outputs)} from one
    spawn of four gloo CPU ranks."""
    jobs = {}
    for arch in archs:
        cfg = configs.get_reduced(arch)
        bt = batch(cfg)
        steps = ("prefill", "loss") + (("grad", "train") if arch in train_archs else ())
        runs = [{"shape": mesh, "step": step, "batch": bt, "opt": OPT}
                for mesh in MESHES for step in steps]
        if cfg.kind != "encdec":        # its decode takes the encoder's cross K/V
            runs += [{"shape": mesh, "step": "decode", "batch": decode_batch(cfg),
                      "cache_len": DECODE_CACHE, "pos0": DECODE_POS} for mesh in MESHES]
        jobs[arch] = (cfg, bridged_params(arch), bt, runs)
    reports = di.spawn_ranks(4, shd.run_sharded,
                             [(cfg, p, runs) for cfg, p, _, runs in jobs.values()],
                             backend="gloo", device="cpu", timeout_s=240)
    return {arch: (*job, [rep["result"][j] for rep in reports])
            for j, (arch, job) in enumerate(jobs.items())}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: v})
    return out


def within(want: torch.Tensor, got: torch.Tensor, what: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype, what
    want, got = want.double(), got.double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= REL * scale, f"{what}: max error {err:.3g} > {REL} x {scale:.3g}"


def _runs_of(sharded, arch, step):
    """[(run, [rank 0's output, rank 1's, ...])] of one step."""
    runs, outs = sharded[arch][3], sharded[arch][4]
    return [(run, [o[i] for o in outs]) for i, run in enumerate(runs) if run["step"] == step]


def check_prefill(sharded, arch):
    cfg, params, bt = sharded[arch][:3]
    want = M.prefill(params, cfg, {k: v for k, v in bt.items() if k != "labels"})
    runs = _runs_of(sharded, arch, "prefill")
    assert len(runs) == len(MESHES)
    for run, per_rank in runs:
        for rank, got in enumerate(per_rank):
            within(want, got, f"{arch} {run['shape']} rank {rank} logits")


def check_loss(sharded, arch):
    cfg, params, bt = sharded[arch][:3]
    total, metrics = M.train_loss(params, cfg, bt)
    runs = _runs_of(sharded, arch, "loss")
    assert len(runs) == len(MESHES)
    for run, per_rank in runs:
        for rank, (got_total, got_metrics) in enumerate(per_rank):
            within(total, got_total, f"{arch} {run['shape']} rank {rank} loss")
            if metrics["aux"].abs() > 0:
                within(metrics["aux"], got_metrics["aux"], f"{arch} aux")
            assert int(got_metrics["tokens"]) == int(metrics["tokens"])


def check_decode(sharded, arch):
    cfg, params = sharded[arch][:2]
    runs = _runs_of(sharded, arch, "decode")
    assert len(runs) == len(MESHES)
    bt = runs[0][0]["batch"]
    caches = M.make_caches(cfg, bt["tokens"].shape[0], DECODE_CACHE, torch.float32,
                           device="cpu")
    want_logits, want_caches = M.decode_step(params, cfg, caches, bt["tokens"], DECODE_POS)
    for run, per_rank in runs:
        for rank, (logits, got_caches) in enumerate(per_rank):
            within(want_logits, logits, f"{arch} {run['shape']} rank {rank} decode logits")
            got = _leaves(got_caches)
            for path, leaf in _leaves(want_caches).items():
                if leaf.abs().max() > 0:
                    within(leaf, got[path], f"{arch} {run['shape']} cache {path}")
                else:
                    assert torch.equal(got[path], leaf), path


def check_train(sharded, arch):
    cfg, params, bt = sharded[arch][:3]
    (want_total, want_metrics), want_g = value_and_grad(cfg)(params, bt)
    grads = _runs_of(sharded, arch, "grad")
    steps = _runs_of(sharded, arch, "train")
    assert len(grads) == len(steps) == len(MESHES)
    for (run, g_ranks), (_, s_ranks) in zip(grads, steps):
        (got_total, _), got_g = g_ranks[0]
        within(want_total, got_total, f"{arch} {run['shape']} loss")
        for path, leaf in _leaves(want_g).items():
            within(leaf, _leaves(got_g)[path], f"{arch} {run['shape']} grad {path}")
        # the sharded step == AdamW on its own gradients, unsharded
        want_p, want_o, want_m = adamw_update(params, got_g, init_opt_state(params, OPT), OPT)
        got_p, got_o, got_m = s_ranks[0]
        want = {**_leaves(want_p, "params"), **_leaves({"m": want_o["m"], "v": want_o["v"]})}
        got = {**_leaves(got_p, "params"), **_leaves({"m": got_o["m"], "v": got_o["v"]})}
        assert set(got) == set(want)
        for path, leaf in want.items():
            within(leaf, got[path], f"{arch} {run['shape']} step {path}")
        assert int(got_o["step"]) == 1
        for key in ("grad_norm", "lr"):
            within(want_m[key], got_m[key], f"{arch} {run['shape']} {key}")
        within(want_metrics["loss"], got_m["loss"], f"{arch} {run['shape']} step loss")
        for other in s_ranks[1:]:           # every rank holds the same step
            for path, leaf in _leaves(other[0], "params").items():
                assert torch.equal(leaf, got[path]), path


def fixture(archs, train_archs=()):
    """A module-scoped fixture running ``spawn(archs, train_archs)``."""
    return pytest.fixture(scope="module")(lambda: spawn(archs, train_archs))


__all__ = ["MESHES", "OPT", "REL", "batch", "bridged_params", "spawn", "within",
           "check_prefill", "check_loss", "check_decode", "check_train", "fixture"]
