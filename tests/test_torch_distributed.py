"""Port: the multi-device layer (core/mesh, the data-parallel train steps and
fit(mesh=)) on 2 CPU ranks over gloo, against the single-process port and
the JAX package on 2 of its 8 virtual CPU devices.

The ranks are spawned processes (torch.multiprocessing, a file store under
the test's tmp_path, a 60 s group timeout, joined with a deadline), which
import this module without JAX; the JAX side runs in the test process. Each
worker writes what it computed to tmp_path and the tests compare.

Models: FISRnet ch=8 and PWC-Net pyr_lvls=4 / flow_pred_lvl=2 (as
tests/test_distributed.py), on the oracle generator's damped weights,
carried into the JAX trees with convert/params; 32x32 inputs; lr 1e-4
(FISRnet) and 1e-5 (PWC-Net in the joint step). Tolerances, with what was
measured here:
* the ranks after a data-parallel step: metrics, averaged gradients and
  every parameter bit-equal between the two ranks (measured: equal).
* against the single-process port step on the same global batch: metrics
  rtol 1e-5 (measured 2.3e-7); averaged gradients within 5e-4 of the
  tree's largest gradient (measured 2.6e-6 FISRnet, 9.1e-8 PWC-Net, 1.1e-4
  joint: a FISRnet bias whose gradient sums +-1-like Charbonnier terms that
  cancel, the leaf tests/test_torch_joint.py names); every parameter within
  rtol 2e-5 / atol 1e-7 but for at most 0.01 % of the entries, which may be
  up to 2*lr apart (Adam's first update is about sign(g)*lr, so an entry
  whose gradient is summation noise may flip; measured: none, largest
  difference 1.9e-8).
* the loss against the JAX step on a (2, 1) mesh: rtol 2e-5 (measured
  2.9e-7), the bound of tests/test_torch_{train,pwc_train,joint}.py.
* fit(mesh=) with its model at ch=8 (`_narrow_state`), 2 epochs of 1 step:
  metrics.jsonl against a single-process fit, rtol 1e-5 (measured 1.3e-7;
  3.8e-7 at full width); the final parameters within 2*lr a step (measured
  8.9e-8; 1.0e-5 at full width: fit starts from glorot weights, where more
  gradients are summation noise).
"""

import datetime
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fisr_tpu_torch.convert import params
from fisr_tpu_torch.core import mesh
from fisr_tpu_torch.data import synth
from fisr_tpu_torch.models import pwcnet
from fisr_tpu_torch.train import checkpoint, joint, loop, pwc_trainer, trainer

torch.set_num_threads(1)
WORLD = 2
LR_F, LR_P = 1e-4, 1e-5
PWC_SMALL = dict(pyr_lvls=4, flow_pred_lvl=2)


# ---- running ranks -----------------------------------------------------------------


def _rank_main(rank, world, store, init, fn, args):
    torch.set_num_threads(1)
    if init:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        fn(rank, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, tmp_path, *args, world=WORLD, init=True, timeout=300):
    """fn(rank, *args) in `world` spawned processes joined in one gloo group
    (none with init=False); fails the calling test if a rank raises or the
    ranks are not done within `timeout` seconds."""
    store = os.path.join(str(tmp_path), f"store_{time.monotonic_ns()}")
    ctx = mp.start_processes(_rank_main, args=(world, store, init, fn, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{fn.__name__}: ranks not done after {timeout} s")


def _load(path):
    return torch.load(path, weights_only=False)


# ---- core/mesh ------------------------------------------------------------------------


def _collectives(rank, out):
    res = {}
    m = mesh.make_mesh(device="cpu")
    res["default"] = (tuple(m.shape), m.mesh_dim_names, mesh.axis_index(m, "data"))
    ms = mesh.make_mesh((1, 2), device="cpu")
    res["spatial"] = (tuple(ms.shape), mesh.axis_index(ms, "data"), mesh.axis_index(ms, "spatial"))
    rev = mesh.make_mesh((2, 1), devices=[1, 0], device="cpu")
    res["reversed"] = (mesh.axis_index(rev, "data"),
                       mesh.all_gather_axis(torch.tensor([float(rank)]), rev, "data").tolist(),
                       mesh.ppermute(torch.tensor([float(rank)]), rev, "data", [(0, 1)]).tolist())
    try:
        mesh.make_mesh((4, 1), device="cpu")
    except ValueError as e:
        res["too_big"] = str(e)
    batch = {"data": np.arange(8 * 4 * 4 * 3, dtype=np.float32).reshape(8, 4, 4, 3),
             "label": torch.arange(8.0)}
    res["rows"] = {k: v.numpy() for k, v in mesh.shard_batch(batch, m).items()}
    try:
        mesh.shard_batch({"x": np.zeros((3, 2))}, m)
    except ValueError as e:
        res["odd"] = str(e)
    x = torch.full((2, 3), float(rank + 1))
    res["ring"] = mesh.ppermute(x, m, "data", [(0, 1), (1, 0)]).numpy()
    res["shift"] = [t.numpy() for t in mesh.ppermute([x, 2 * x], m, "data", [(0, 1)])]
    res["identity"] = mesh.ppermute(x, ms, "data", [(0, 0)]).numpy()
    t = [torch.tensor([rank + 1.0, 10.0 * rank]), torch.tensor([3.0 * rank], dtype=torch.float64)]
    mesh.all_reduce_mean_(t, m)
    res["mean"] = [v.numpy() for v in t]
    res["metrics"] = {k: float(v) for k, v in mesh.mean_metrics(
        {"a": torch.tensor(2.0 * rank), "b": torch.tensor(1.0)}, m).items()}
    res["broadcast"] = mesh.broadcast_from(torch.full((3,), float(rank)), m, "data", 1).numpy()
    res["gather"] = mesh.all_gather_axis(torch.full((1, 2), float(rank)), ms, "spatial",
                                         dim=1).numpy()
    model = torch.nn.Linear(2, 2)  # a different init on each rank
    opt = trainer.tf_adam(1e-3)(model.parameters())
    model(torch.ones(1, 2)).sum().backward()
    for _ in range(rank + 1):
        opt.step()
    mesh.replicated(m, model, opt)
    res["replicated"] = ([p.detach().numpy() for p in model.parameters()],
                         [opt.state[p]["mu"].numpy() for p in model.parameters()], opt.count)
    torch.save(res, os.path.join(out, f"collectives_{rank}.pt"))


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("collectives"))
    run_ranks(_collectives, out, out)
    return [_load(os.path.join(out, f"collectives_{r}.pt")) for r in range(WORLD)]


def test_make_mesh_shapes_and_error(collectives):
    import jax

    from fisr_tpu.core import mesh as jmesh

    jm = jmesh.make_mesh(devices=jax.devices()[:2])
    for rank, res in enumerate(collectives):
        assert res["default"] == (tuple(jm.devices.shape), tuple(jm.axis_names), rank)
        assert res["spatial"] == ((1, 2), 0, rank)
        # devices=[1, 0]: rank 1 is index 0 (its group numbers it 1)
        assert res["reversed"] == (1 - rank, [1.0, 0.0], [0.0] if rank else [1.0])
        with pytest.raises(ValueError) as e:
            jmesh.make_mesh((4, 1), devices=jax.devices()[:2])
        assert res["too_big"] == str(e.value) == "mesh shape (4, 1) needs 4 devices, have 2"


def test_make_mesh_starts_a_one_rank_group(tmp_path):
    run_ranks(_one_rank, tmp_path, world=1, init=False)


def _one_rank(_rank):
    m = mesh.make_mesh(device="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert tuple(m.shape) == (1, 1) and mesh.mesh_device(m) == torch.device("cpu")
    x = torch.arange(4.0)
    y = mesh.ppermute(x, m, "data", [(0, 0)])
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    assert torch.equal(mesh.ppermute(x, m, "data", []), torch.zeros(4))
    mesh.all_reduce_mean_([x], m)
    assert torch.equal(x, torch.arange(4.0))


def test_make_mesh_joins_a_launchers_world(monkeypatch):
    """Under `torchrun` (WORLD_SIZE > 1 in the environment) make_mesh starts
    the group from the environment, not a one-rank group of its own."""
    calls = []

    class Started(Exception):
        pass

    def init(*args, **kw):
        calls.append((args, kw))
        raise Started

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", init)
    with pytest.raises(Started):
        mesh.make_mesh(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(Started):
        mesh.make_mesh(device="cpu")
    assert calls[0] == (("gloo",), {})
    assert calls[1][0] == ("gloo",) and calls[1][1]["world_size"] == 1


def test_shard_batch_rows_by_rank(collectives):
    """Mirrors tests/test_distributed.py::test_shard_batch_layout: each rank
    holds its contiguous rows, the JAX shard of the same index."""
    import jax

    from fisr_tpu.core import mesh as jmesh

    jm = jmesh.make_mesh((2, 1), devices=jax.devices()[:2])
    data = np.arange(8 * 4 * 4 * 3, dtype=np.float32).reshape(8, 4, 4, 3)
    shards = sorted(jmesh.shard_batch({"data": data}, jm)["data"].addressable_shards,
                    key=lambda s: s.index[0].start)
    for rank, res in enumerate(collectives):
        assert res["rows"]["data"].shape == (4, 4, 4, 3)
        np.testing.assert_array_equal(res["rows"]["data"], np.asarray(shards[rank].data))
        np.testing.assert_array_equal(res["rows"]["label"], np.arange(4.0) + 4 * rank)
        assert "does not divide" in res["odd"]
    with pytest.raises(ValueError):
        jmesh.shard_batch({"x": np.zeros((3, 2))}, jm)


def test_ppermute_ring_of_two_and_the_size_one_identity(collectives):
    """The ring and the shift against jax.lax.ppermute on 2 devices (a rank
    no pair sends to gets zeros); (0, 0) on an axis of size 1 is the
    identity."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from fisr_tpu.core import mesh as jmesh
    from fisr_tpu.infer.sharded import shard_map

    jm = jmesh.make_mesh((2, 1), devices=jax.devices()[:2])
    x = jnp.concatenate([jnp.full((2, 3), 1.0), jnp.full((2, 3), 2.0)])
    want = {}
    for name, perm in (("ring", [(0, 1), (1, 0)]), ("shift", [(0, 1)])):
        f = shard_map(lambda t, perm=perm: jax.lax.ppermute(t, "data", perm), mesh=jm,
                      in_specs=P("data"), out_specs=P("data"))
        want[name] = np.asarray(jax.jit(f)(x)).reshape(2, 2, 3)
    for rank, res in enumerate(collectives):
        np.testing.assert_array_equal(res["ring"], want["ring"][rank])
        np.testing.assert_array_equal(res["shift"][0], want["shift"][rank])
        np.testing.assert_array_equal(res["shift"][1], 2 * want["shift"][rank])
        np.testing.assert_array_equal(res["identity"], np.full((2, 3), rank + 1.0))


def test_means_broadcast_gather_and_replicated(collectives):
    for res in collectives:
        np.testing.assert_array_equal(res["mean"][0], [1.5, 5.0])
        assert res["mean"][1].dtype == np.float64 and res["mean"][1][0] == 1.5
        assert res["metrics"] == {"a": 1.0, "b": 1.0}
        np.testing.assert_array_equal(res["broadcast"], np.ones(3))
        np.testing.assert_array_equal(res["gather"], [[0.0, 0.0, 1.0, 1.0]])
    (p0, mu0, c0), (p1, mu1, c1) = (res["replicated"] for res in collectives)
    assert c0 == c1 == 1
    for a, b in zip(p0 + mu0, p1 + mu1):
        np.testing.assert_array_equal(a, b)


# ---- the data-parallel train steps --------------------------------------------------

DP_CASES = ("fisr", "pwc", "joint", "joint_frozen")


def _dp_setup(case):
    """(state, make_step(mesh), global batch, models) of a case, the same in
    every process."""
    if case == "fisr":
        model = params.deterministic_fisrnet(ch=8, device="cpu")
        state = trainer.TrainState(model, trainer.tf_adam(LR_F)(model.parameters()))
        batch = next(synth.synthetic_store(n_samples=6, h=32, w=32, seed=0,
                                           val_size=2).batches(4, epoch_seed=0))
        return state, lambda m: trainer.make_train_step(mesh=m), batch, [model]
    cfg = pwcnet.PWCNetConfig(**PWC_SMALL)
    pwc = params.deterministic_pwcnet(cfg, device="cpu")
    if case == "pwc":
        state = trainer.TrainState(pwc, trainer.tf_adam(LR_F)(pwc.parameters()))
        rng = np.random.default_rng(1)
        batch = {"x": rng.uniform(size=(4, 2, 32, 32, 3)).astype(np.float32),
                 "y": rng.normal(size=(4, 32, 32, 2)).astype(np.float32)}
        return state, lambda m: pwc_trainer.make_pwc_train_step(mesh=m), batch, [pwc]
    fisr = params.deterministic_fisrnet(ch=8, device="cpu")
    state = joint.create_joint_state(fisr, pwc, trainer.tf_adam(LR_F),
                                     trainer.tf_adam(LR_P) if case == "joint" else None)
    frames, target = synth.synthetic_video_windows(2, h=32, w=32, seed=0)
    return (state, lambda m: joint.make_joint_train_step(mesh=m),
            {"frames": frames, "target": target}, [fisr, pwc])


def _dp_record(state, metrics, models):
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": [None if p.grad is None else p.grad.clone() for mod in models
                      for p in mod.parameters()],
            "params": [p.detach().clone() for mod in models for p in mod.parameters()],
            "step": state.step}


def _dp_steps(rank, out):
    m = mesh.make_mesh((WORLD, 1), device="cpu")
    for case in DP_CASES:
        state, make_step, batch, models = _dp_setup(case)
        state, metrics = make_step(m)(state, mesh.shard_batch(batch, m))
        torch.save(_dp_record(state, metrics, models), os.path.join(out, f"{case}_{rank}.pt"))


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp"))
    run_ranks(_dp_steps, out, out)
    return {case: [_load(os.path.join(out, f"{case}_{r}.pt")) for r in range(WORLD)]
            for case in DP_CASES}


def _jax_loss(case):
    """The first metric of the JAX step on the same weights and global
    batch, the batch sharded over a (2, 1) mesh and the state replicated."""
    import jax
    import jax.numpy as jnp

    from fisr_tpu.core import mesh as jmesh
    from fisr_tpu.models import pwcnet as jpwcnet
    from fisr_tpu.train import joint as jjoint
    from fisr_tpu.train import pwc_trainer as jpwc_trainer
    from fisr_tpu.train import trainer as jtrainer

    state, _, batch, models = _dp_setup(case)
    trees = [jax.tree_util.tree_map(jnp.asarray, params.to_jax_tree(mod)) for mod in models]
    jm = jmesh.make_mesh((2, 1), devices=jax.devices()[:2])
    jbatch = jmesh.shard_batch({k: np.asarray(v) for k, v in batch.items()}, jm)
    jcfg = jpwcnet.PWCNetConfig(**PWC_SMALL, cost_volume_impl="xla")
    if case == "fisr":
        jopt = jtrainer.tf_adam(LR_F)
        jstate = jtrainer.TrainState(trees[0], jopt.init(trees[0]), jnp.zeros((), jnp.int32))
        jstep, key = jtrainer.make_train_step(jopt, donate=False), "total_loss"
    elif case == "pwc":
        jopt = jtrainer.tf_adam(LR_F)
        jstate = jtrainer.TrainState(trees[0], jopt.init(trees[0]), jnp.zeros((), jnp.int32))
        jstep, key = jpwc_trainer.make_pwc_train_step(jopt, jcfg, donate=False), "loss"
    else:
        jf = jtrainer.tf_adam(LR_F)
        jp = jtrainer.tf_adam(LR_P) if case == "joint" else None
        jstate = jjoint.create_joint_state(*trees, jf, jp)
        jstep, key = jjoint.make_joint_train_step(jf, jp, cfg=jcfg, donate=False), "joint_loss"
    jstate = jax.device_put(jstate, jmesh.replicated(jm))
    return key, float(jstep(jstate, jbatch)[1][key])


@pytest.mark.parametrize("case", DP_CASES)
def test_dp_step_matches_single_process_and_jax(dp_steps, case):
    """2 ranks x half the batch == one process on the whole batch (see the
    module docstring for the bounds); the ranks bit-equal."""
    r0, r1 = dp_steps[case]
    assert r0["metrics"] == r1["metrics"] and r0["step"] == r1["step"] == 1
    for a, b in zip(r0["grads"] + r0["params"], r1["grads"] + r1["params"]):
        assert (a is None and b is None) or torch.equal(a, b)

    state, make_step, batch, models = _dp_setup(case)
    state, want = make_step(None)(state, batch)
    ref = _dp_record(state, want, models)
    assert r0["metrics"].keys() == ref["metrics"].keys()
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-5, err_msg=k)
    top = max(float(g.abs().max()) for g in ref["grads"] if g is not None)
    for got, g in zip(r0["grads"], ref["grads"]):
        assert (got is None) == (g is None)
        if g is not None:
            assert (got - g).abs().max() <= 5e-4 * top
    loose = total = 0
    lr = {id(p): (LR_P if case == "joint" and i >= 1 else LR_F)
          for i, mod in enumerate(models) for p in mod.parameters()}
    flat = [p for mod in models for p in mod.parameters()]
    for p, got, want_p in zip(flat, r0["params"], ref["params"]):
        err = (got - want_p).abs()
        assert err.max() <= 2 * lr[id(p)] + 1e-7
        loose += int((err > 1e-7 + 2e-5 * want_p.abs()).sum())
        total += err.numel()
    assert loose <= 1e-4 * total, (loose, total)
    if case == "joint_frozen":
        assert all(g is None for g in r0["grads"][len(list(models[0].parameters())):])

    key, jloss = _jax_loss(case)
    np.testing.assert_allclose(r0["metrics"][key], jloss, rtol=2e-5)


# ---- fit(mesh=) -----------------------------------------------------------------------


def _fit_store():
    return synth.synthetic_store(n_samples=4, h=32, w=32, seed=0, val_size=2)


FIT_KW = dict(batch_size=2, val_batch_size=2, lr_type="no_decay", freq_display=1)


def _narrow_state(seed, optimizer, device):
    """fit's state at ch=8: fit builds the full-width model, whose 48 M
    parameters made each rank take 2.6 GB of memory and the test 1.5 GB of
    checkpoints, the suite's largest share of both; its data-parallel logic
    does not depend on the width (full width: tests/test_torch_train.py)."""
    return trainer.create_state(seed, optimizer, ch=8, device=device)


def _fit_ranks(rank, root):
    loop.create_state = _narrow_state  # this spawned rank's own module
    m = mesh.make_mesh(device="cpu")
    kw = dict(ckpt_dir=os.path.join(root, "ckpt"), log_dir=os.path.join(root, "log"), **FIT_KW)
    first = loop.fit(_fit_store(), epochs=1, mesh=m, **kw)
    step1 = first.step
    resumed = loop.fit(_fit_store(), epochs=2, mesh=m, **kw)
    torch.save({"steps": (step1, resumed.step, resumed.optimizer.count),
                "params": [p.detach().clone() for p in resumed.model.parameters()]},
               os.path.join(root, f"fit_{rank}.pt"))


def test_fit_with_a_mesh_matches_single_process_fit_and_resumes(tmp_path, monkeypatch):
    """fit(mesh=) on 2 ranks, one epoch, then a second call that resumes
    from its checkpoint for a second epoch: the metrics.jsonl that rank 0
    alone writes against a single-process fit doing the same (rtol 1e-5, see
    the module docstring), the ranks' final parameters bit-equal."""
    dp, single = tmp_path / "dp", tmp_path / "single"
    run_ranks(_fit_ranks, tmp_path, str(dp))
    r0, r1 = (_load(os.path.join(dp, f"fit_{r}.pt")) for r in range(WORLD))
    assert r0["steps"] == r1["steps"] == (1, 2, 2)
    assert all(torch.equal(a, b) for a, b in zip(r0["params"], r1["params"]))
    assert checkpoint.CheckpointManager(str(dp / "ckpt")).latest_step() == 2

    kw = dict(ckpt_dir=str(single / "ckpt"), log_dir=str(single / "log"), device="cpu", **FIT_KW)
    monkeypatch.setattr(loop, "create_state", _narrow_state)
    loop.fit(_fit_store(), epochs=1, **kw)
    state = loop.fit(_fit_store(), epochs=2, **kw)

    def records(root):
        with open(os.path.join(root, "log", "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    got, want = records(dp), records(single)
    # one line an epoch: rank 1 wrote none
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    err = max(float((a - b.detach()).abs().max())
              for a, b in zip(r0["params"], state.model.parameters()))
    assert err <= 2 * 2 * LR_F + 1e-6


def test_prefetch_to_device_cuts_the_rank_rows():
    batches = [{"x": np.arange(12.0).reshape(4, 3)}, {"x": np.arange(12.0, 24.0).reshape(4, 3)}]
    shard = lambda nd: mesh.Shard(1, 2, 0, nd)  # noqa: E731 (rank 1 of 2)
    got = list(loop.prefetch_to_device(iter(batches), "cpu", sharding=shard))
    assert [g["x"].tolist() for g in got] == [b["x"][2:].tolist() for b in batches]
    with pytest.raises(ValueError):
        mesh.Shard(0, 3)(np.zeros((4, 3)))
