"""Port: the PWC-Net training step as one CUDA graph
(train/pwc_trainer.make_pwc_train_step) and the TFAdam update that reads its
learning rate and bias correction from the device (train/trainer.TFAdam,
`begin_step` and `update`).

On the CPU: TFAdam against the JAX package's `tf_adam` over six steps of a
multisteps schedule whose rate halves after the third, at the bounds of
tests/test_torch_pwc_train.py's three-step test (parameters rtol 2e-5 / atol
1e-7, moments within 1e-4 of each leaf's largest entry); the step stays eager
on the CPU and with a mesh (its counters); the graph's binding to the
state and batch its capture baked in (`_StepGraph._bind`); the benchmark's
reader of `graph_step_pct.train` on made-up totals.

Marked `cuda` (skip without a card), on the card:

    python -m pytest tests/test_torch_pwc_graph.py -q -m cuda

graphed steps against eager ones under deterministic cuDNN with TF32 off, f32
and bf16, across the schedule's boundary: every loss, parameter and moment
bit-equal; a loss keeps its value after later steps; a second batch shape
and a fresh state capture anew; the cost-volume kernels' launches in the profiler's trace of
replayed steps; the host at most two steps ahead of the card. JAX is imported
inside the one test that compares with it, so the file collects on a machine
with PyTorch alone.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fisr_tpu_torch.convert import params
from fisr_tpu_torch.kernels import cost_volume as kernel
from fisr_tpu_torch.models import pwcnet
from fisr_tpu_torch.ops.conv import BF16, F32
from fisr_tpu_torch.train import pwc_trainer, schedule, trainer
from fisr_tpu_torch.utils import profiling

torch.set_num_threads(1)
SMALL = dict(pyr_lvls=4, flow_pred_lvl=2, search_range=2)
LR = 1e-4
COUNTERS = ("train.steps", "train.graph_captures", "train.graph_replays")


def _batch(seed=1, b=2, h=64, w=64):
    rng = np.random.default_rng(seed)
    return {"x": rng.uniform(size=(b, 2, h, w, 3)).astype(np.float32),
            "y": rng.normal(size=(b, h, w, 2)).astype(np.float32)}


def _counters() -> dict:
    c = profiling.totals()["counters"]
    return {k: c.get(k, 0) for k in COUNTERS}


def _moved(before: dict) -> dict:
    now = _counters()
    return {k: now[k] - before[k] for k in COUNTERS}


def _state(device, boundary=2):
    """The oracle generator's PWC-Net at SMALL and a TFAdam whose rate halves
    after `boundary` + 1 steps."""
    model = params.deterministic_pwcnet(pwcnet.PWCNetConfig(**SMALL), device=device)
    opt = trainer.tf_adam(schedule.multisteps([LR, LR / 2], [boundary]))(model.parameters())
    return trainer.TrainState(model, opt)


# ---- the CPU ---------------------------------------------------------------------


def test_tfadam_device_scalars_match_jax_across_the_boundary():
    import jax.numpy as jnp
    import optax

    from fisr_tpu.train import schedule as jschedule
    from fisr_tpu.train import trainer as jtrainer

    rng = np.random.default_rng(0)
    shapes = {"w": (3, 3, 4, 5), "b": (5,), "quiet": (7,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # `quiet` has gradients near eps, where TF's eps placement shows
    grads = [{k: (rng.normal(size=s) * (1e-8 if k == "quiet" else 1.0)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(6)]
    sched = ([LR, LR / 2], [2])

    jopt = jtrainer.tf_adam(jschedule.multisteps(*sched))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jp)
    leaves = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = trainer.tf_adam(schedule.multisteps(*sched))(list(leaves.values()))
    flat = trainer.tf_adam(LR)([torch.nn.Parameter(torch.from_numpy(p0["w"].copy()))])
    for n, g in enumerate(grads, start=1):
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in leaves.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        flat.param_groups[0]["params"][0].grad = torch.from_numpy(g["w"])
        flat.step()
        for k, p in leaves.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=2e-5,
                                       atol=1e-7, err_msg=f"{k}, step {n}")
            for field in ("mu", "nu"):
                ref = np.asarray(getattr(jstate[0], field)[k])
                got = opt.state[p][field].numpy()
                assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max() + 1e-12, (field, k, n)
        # the halved rate takes effect from the fourth step: the same leaf
        # under a constant rate parts from the schedule's there, by about
        # half an update (Adam's first updates are about lr * sign(g))
        gap = (flat.param_groups[0]["params"][0] - leaves["w"]).abs().max().item()
        assert (gap == 0.0) if n <= 3 else (gap >= 0.3 * LR), (n, gap)
    assert opt.count == 6 and opt.current_lr() == LR / 2


@pytest.mark.parametrize("with_mesh", [False, True], ids=["cpu", "mesh"])
def test_step_stays_eager_on_the_cpu_and_with_a_mesh(with_mesh):
    from fisr_tpu_torch.core import mesh as mesh_lib

    own = with_mesh and not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_mesh(device="cpu") if with_mesh else None
        state = _state("cpu")
        step = pwc_trainer.make_pwc_train_step(loss_mode="multiscale", mesh=mesh)
        before = _counters()
        for n in range(1, 5):
            state, m = step(state, _batch(b=1, h=32, w=32))
            assert state.step == n and np.isfinite(float(m["loss"]))
    finally:
        if own:
            dist.destroy_process_group()
    assert _moved(before) == {"train.steps": 4, "train.graph_captures": 0,
                              "train.graph_replays": 0}


def _fresh_state(state, batch):
    return _state("cpu"), batch


def _moments_loaded(state, batch):
    """torch's `load_state_dict` from a saved copy: new moment tensors."""
    import copy

    state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    return state, batch


def _parameter_replaced(state, batch):
    p = next(state.model.parameters())
    p.data = p.data.clone()
    return state, batch


def _other_crop(state, batch):
    return state, {k: v[:, :, :16] if k == "x" else v[:, :16] for k, v in batch.items()}


def _deterministic(state, batch):
    torch.backends.cudnn.deterministic = not torch.backends.cudnn.deterministic
    return state, batch


@pytest.mark.parametrize("change", [None, _fresh_state, _moments_loaded, _parameter_replaced,
                                    _other_crop, _deterministic],
                         ids=["same", "fresh_state", "moments_loaded", "parameter_replaced",
                              "other_crop", "deterministic_flag"])
def test_the_graph_is_bound_to_what_its_capture_baked_in(change):
    """`_StepGraph._bind` on the CPU: the same state and batch keep the
    binding; a fresh state, new moment or parameter tensors, another batch
    shape or another cuDNN flag start a new one."""
    state = _state("cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(b=1, h=32, w=32).items()}
    g = pwc_trainer._StepGraph(None, None)
    assert not g._bind(state, batch)
    assert g._bind(state, batch)
    flag = torch.backends.cudnn.deterministic
    try:
        state, batch = change(state, batch) if change else (state, batch)
        assert g._bind(state, batch) == (change is None)
        assert g._bind(state, batch)  # and the new binding holds
    finally:
        torch.backends.cudnn.deterministic = flag


@pytest.mark.parametrize("counters,want", [
    ({"train.steps": 40, "train.graph_captures": 1, "train.graph_replays": 38}, 95.0),
    ({"train.steps": 3, "train.graph_captures": 1, "train.graph_replays": 1}, 100.0 / 3),
    ({"train.steps": 8, "data.batches": 8}, 0.0),  # every step eager
    ({"train.steps": 0, "train.graph_replays": 0}, None),
    ({"data.batches": 8}, None),  # a program that counts no steps
    (None, None),  # a program with no recorder
])
def test_graph_step_reader_on_made_up_totals(monkeypatch, counters, want):
    """The benchmark's `graph_step_pct.train` reader over `counters` given as
    the program's recorder's totals."""
    from fisrbench.harness.manifest import Manifest

    totals = None if counters is None else (lambda: {"spans": {}, "counters": counters})
    monkeypatch.setattr(profiling, "totals", totals)
    got = Manifest().reader("graph_step_pct.train")({})
    assert got == (None if want is None else pytest.approx(want, rel=1e-12))


# ---- the card ----------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        yield torch.device("cuda")


def _run(device, policy, batches, graph: bool):
    """(losses as read after each step, the loss tensors, the final state)."""
    state = _state(device)
    step = pwc_trainer.make_pwc_train_step(policy=policy, graph=graph)
    losses, kept = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        kept.append(m["loss"])
    torch.cuda.synchronize()
    return losses, kept, state


def _assert_states_equal(a: trainer.TrainState, b: trainer.TrainState):
    assert a.step == b.step and a.optimizer.count == b.optimizer.count
    for (k, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), k
        for field in ("mu", "nu"):
            assert torch.equal(a.optimizer.state[p][field], b.optimizer.state[q][field]), (k, field)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [F32, BF16], ids=["f32", "bf16"])
def test_graphed_steps_equal_eager_steps(card, policy):
    batches = [_batch(seed=s) for s in range(6)]
    want, _, eager = _run(card, policy, batches, graph=False)
    before = _counters()
    got, kept, graphed = _run(card, policy, batches, graph=True)
    assert _moved(before) == {"train.steps": 6, "train.graph_captures": 1,
                              "train.graph_replays": 4}
    assert got == want
    _assert_states_equal(graphed, eager)
    # each step's loss is its own tensor: later replays leave it as it was read
    assert [float(t) for t in kept] == got and len({t.data_ptr() for t in kept}) == 6
    assert graphed.optimizer.current_lr() == LR / 2


@pytest.mark.cuda
def test_a_second_batch_shape_captures_anew(card):
    batches = [_batch(seed=s) for s in range(4)] + [_batch(seed=s, h=32) for s in range(4, 8)]
    want, _, eager = _run(card, F32, batches, graph=False)
    before = _counters()
    got, _, graphed = _run(card, F32, batches, graph=True)
    assert _moved(before) == {"train.steps": 8, "train.graph_captures": 2,
                              "train.graph_replays": 4}
    assert got == want
    _assert_states_equal(graphed, eager)


@pytest.mark.cuda
def test_a_fresh_state_captures_anew(card):
    """One step function, a second state made after the first is dropped:
    the caching allocator may hand it the first state's memory, and the
    step must still capture anew for it."""
    batches = [_batch(seed=s) for s in range(4)]
    want, _, eager = _run(card, F32, batches, graph=False)
    step = pwc_trainer.make_pwc_train_step(policy=F32)
    before = _counters()
    for _ in range(2):
        state = _state(card)
        got = []
        for b in batches:
            state, m = step(state, b)
            got.append(float(m["loss"]))
        torch.cuda.synchronize()
        assert got == want
        _assert_states_equal(state, eager)
        del state, m
    assert _moved(before) == {"train.steps": 8, "train.graph_captures": 2,
                              "train.graph_replays": 4}


@pytest.mark.cuda
def test_replayed_steps_launch_the_cost_volume_kernels(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state = _state(card)
    step = pwc_trainer.make_pwc_train_step(policy=F32)
    batch = {k: torch.as_tensor(v, device=card) for k, v in _batch().items()}
    for _ in range(3):  # two eager calls and the capture
        state, _m = step(state, batch)
    launches = (kernel.LAUNCHES, kernel.BACKWARD_LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, _m = step(state, batch)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    levels = SMALL["pyr_lvls"] - SMALL["flow_pred_lvl"] + 1
    assert sum("cost_volume_kernel" in n for n in names) == 2 * levels
    assert sum("cost_volume_bwd" in n for n in names) == 2 * levels
    # the launch counters count the wrapper's calls: a replay adds none
    assert (kernel.LAUNCHES, kernel.BACKWARD_LAUNCHES) == launches


@pytest.mark.cuda
def test_the_host_runs_at_most_two_steps_ahead(card):
    state = _state(card)
    step = pwc_trainer.make_pwc_train_step(policy=F32)
    batch = {k: torch.as_tensor(v, device=card) for k, v in _batch().items()}
    for _ in range(3):  # two eager calls and the capture
        state, _m = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # about a second of card time before the next steps
    slept = torch.cuda.Event()
    slept.record()
    for _ in range(2):  # their waits are on steps already done
        state, _m = step(state, batch)
    assert not slept.query(), "the replays waited for the card"
    state, _m = step(state, batch)  # waits for the first of the two
    assert slept.query(), "the host ran three steps ahead of the card"
    torch.cuda.synchronize()
