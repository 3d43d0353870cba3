"""The port's data parallelism on the CPU (gloo ranks): the sharded epoch
iterators against the JAX package's, a two-rank training step against one
process on the concatenated batch and that against the JAX package's step,
the guarded update under data parallelism, the split oracle, the trainer in
two ranks and the dry run of the three multi-card programs."""
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.config import load_config as jax_load_config
from rdm_tpu.data import datasets as jax_datasets
from rdm_tpu.models import NCSNpp as JNCSNpp
from rdm_tpu.models import ema as jax_ema
from rdm_tpu.sde import RVESDE as JRVESDE
from rdm_tpu.training import get_optimizer as jax_get_optimizer
from rdm_tpu.training import make_train_step as jax_make_train_step
from rdm_tpu.training.state import TrainState as JTrainState
from rdm_tpu_torch import data
from rdm_tpu_torch.benchmark import dp_check
from rdm_tpu_torch.config import load_config
from rdm_tpu_torch.data import datasets
from rdm_tpu_torch.dryrun import dryrun_multichip
from rdm_tpu_torch.models import NCSNpp
from rdm_tpu_torch.models.convert import state_dict_from_jax
from rdm_tpu_torch.ops import _build
from rdm_tpu_torch.parallel import launch, mesh
from rdm_tpu_torch.physics import solver_gpu as sg
from rdm_tpu_torch.training import checkpoints

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUND2 = os.path.join(ROOT, "benchmark_results", "round2_flagship_1024", "gto_halo",
                      "generated_samples.npy")
# float32, no dropout or label drop, no warmup: the first step moves every weight
SMALL = ["model.nf=16", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
         "model.attn_resolutions=[9]", "model.dropout=0.0", "model.cond_drop_prob=0.0",
         "optim.warmup=0", "optim.lr=0.001"]
RANK_ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------------------
# sharded iterators

@pytest.mark.parametrize("n,batch", [(50, 8), (5, 8)])
@pytest.mark.parametrize("shard", [(1, 0), (2, 0), (2, 1), (3, 2)])
def test_epoch_iterator_shards_match_jax(shard, n, batch):
    """Every shard of three epochs, batch for batch and bit for bit; the
    (5, 8) set is smaller than one batch (sampled with replacement)."""
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(n, 1, 9, 9)).astype(np.float32)
    labels = rng.uniform(size=(n, 1)).astype(np.float32)
    ours = datasets._epoch_iterator(images, labels, batch, seed=3, shard=shard)
    theirs = jax_datasets._epoch_iterator(images, labels, batch, seed=3, shard=shard)
    share = len(range(shard[1], n, shard[0]))
    per_epoch = share // batch if share >= batch else 1
    for _ in range(3 * per_epoch):
        (oi, ol), (ti, tl) = next(ours), next(theirs)
        np.testing.assert_array_equal(oi, ti)
        np.testing.assert_array_equal(ol, tl)


def test_get_dataset_yields_per_rank_batches(tmp_path):
    """A global batch of 8 over 2 ranks: rank 1's iterators are the JAX
    iterators of shard (2, 1) at batch 4 (seeds 0, 1 and 7); a global batch
    the world does not divide raises the JAX package's message."""
    pkl = data.make_synthetic_gto_pkl(str(tmp_path / "s.pkl"), n=40)
    cfg = load_config("train", [f"data.pkl_path={pkl}", "training.batch_size=8",
                                "eval.batch_size=6", "data.gto_mean=0", "data.gto_std=1"])
    images, labels = data.load_arrays(cfg)
    train, ev = data.get_dataset(cfg, shard=(2, 1))
    evaluation = data.get_dataset(cfg, evaluation=True, shard=(2, 1))
    for it, b, seed, shuffle in ((train, 4, 0, True), (ev, 3, 1, True),
                                 (evaluation, 3, 7, False)):
        ref = jax_datasets._epoch_iterator(images, labels, b, seed=seed, shard=(2, 1),
                                           shuffle=shuffle)
        for _ in range(4):
            np.testing.assert_array_equal(next(it)[0], next(ref)[0])
    with pytest.raises(ValueError, match="Train batch size 8 not divisible by 3 hosts"):
        data.get_dataset(cfg, shard=(3, 0))


def test_world_of_one_without_a_launcher(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.env_ranks() == (0, 1, 0) and not mesh.launched()
    assert mesh.setup("cpu") == torch.device("cpu") and not mesh.initialized()
    assert mesh.world_size() == 1 and mesh.rank() == 0
    x = torch.arange(6.0)
    mesh.all_reduce_mean_([x])
    assert torch.equal(x, torch.arange(6.0)) and mesh.gather_rows(x) is x
    assert mesh.rank_seed(42) == 42 and mesh.rank_seed(42, 0) == 42
    seeds = {mesh.rank_seed(42, r) for r in range(1, 5)}
    assert len(seeds) == 4 and 42 not in seeds
    assert mesh.rank_seed(42, 1) == int(np.random.SeedSequence([42, 1]).generate_state(1)[0])
    assert torch.equal(mesh.shard_rows(torch.arange(8), 1, 2), torch.arange(4, 8))
    with pytest.raises(ValueError, match="Eval batch size 6 not divisible by 4 hosts"):
        mesh.per_rank(6, "Eval", 4)


def test_launched_rank_takes_its_local_card(monkeypatch):
    """Under a launcher, no device and ``"cuda"`` without an index both
    mean ``cuda:LOCAL_RANK``, made current; an index or the CPU is kept.
    The card count and the process group are mocked."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    current, backends = [], []
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(mesh.dist, "init_process_group",
                        lambda backend, **kw: backends.append(backend))
    card1 = torch.device("cuda", 1)
    assert mesh.setup(None) == card1 and mesh.setup("cuda") == card1
    assert mesh.setup("cuda:0") == torch.device("cuda", 0)
    assert mesh.setup("cpu") == torch.device("cpu")
    assert current == [card1, card1, torch.device("cuda", 0)]
    assert backends == ["nccl", "nccl", "nccl", "gloo"]


def test_first_loads_from_threads_build_once(tmp_path, monkeypatch):
    """Threads that reach a library's first use together (a solve split over
    cards) run one build into an empty build directory and load one file;
    ``nvcc`` is a script that takes its time and counts its calls."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\necho x >> {calls}\nsleep 0.3\n"
                    'while [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n')
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build_dir))
    loaded = []
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    _build._load.cache_clear()
    try:
        with ThreadPoolExecutor(4) as pool:
            libs = list(pool.map(_build.load_library, ["cr3bp_shoot"] * 4))
    finally:
        _build._load.cache_clear()
    assert calls.read_text().split() == ["x"] and len(loaded) == 1
    assert set(libs) == {loaded[0]} and os.path.isfile(loaded[0])
    assert sorted(os.listdir(build_dir)) == sorted(
        os.path.basename(loaded[0])[:-3] + ext for ext in (".so", ".log"))


# ---------------------------------------------------------------------------
# the training step over two ranks

def small_setup(seed=0):
    jcfg, cfg = jax_load_config("train", SMALL), load_config("train", SMALL)
    jmodel = JNCSNpp.from_config(jcfg)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 9, 9, 1)), jnp.full((2,), 0.5), jnp.zeros((2, 1)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda s: (0.2 * rng.normal(size=s.shape)).astype(np.float32),
                          shapes["params"])
    return jcfg, cfg, jmodel, params


def global_batch(B=8, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.95, (B, 9, 9, 1)).astype(np.float32),
            rng.uniform(size=(B, 1)).astype(np.float32),
            rng.uniform(1e-5, 1.0, (B,)).astype(np.float32),
            rng.standard_normal((B, 9, 9, 1)).astype(np.float32))


def two_rank_step(tmp_path, spec):
    path = str(tmp_path / "spec.pt")
    torch.save(spec, path)
    launch.run_ranks(["-m", "rdm_tpu_torch.benchmark.dp_check", "step", path, str(tmp_path)],
                     2, env=RANK_ENV, timeout=120)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]


def one_process_step(spec):
    cfg, state, batch, labels, t, z, draws = dp_check.load_step_spec(spec, torch.device("cpu"))
    loss, grads = dp_check.train_step_rows(cfg, state, batch, labels, t, z, draws,
                                           slice(None))
    return dp_check.step_result(state, loss, grads, 0, 0)


@pytest.fixture(scope="module")
def small_spec():
    jcfg, cfg, jmodel, params = small_setup()
    batch, labels, t, z = global_batch()
    spec = {"overrides": SMALL, "model_state": state_dict_from_jax(params), "device": "cpu",
            "batch": nchw(batch), "labels": torch.from_numpy(labels),
            "t": torch.from_numpy(t), "z": nchw(z)}
    return spec, (jcfg, jmodel, params, batch, labels, t, z)


def test_two_rank_step_matches_one_process_and_jax(tmp_path, small_spec):
    """Two gloo ranks, 4 rows each, against one process on the 8 rows, and
    that against the JAX package's step on the same global batch, t and z.
    The ranks end bit for bit alike.  Against one process only the order
    of the gradient's sum over the batch differs (two halves, then their
    mean): the gradients and the moments agree within 1e-5 of each tensor's
    largest value (a float32 sum of some 650 terms a weight, reordered;
    measured 1.1e-6), the parameters and the EMA within 1e-6 (one Adam step
    of lr 1e-3 moves a weight by at most about lr)."""
    spec, (jcfg, jmodel, params, batch, labels, t, z) = small_spec
    r0, r1 = two_rank_step(tmp_path, spec)
    for key in ("grads", "params", "mu", "nu", "shadow"):
        for a, b in zip(r0[key], r1[key]):
            assert torch.equal(a, b), key
    assert r0["loss"] == r1["loss"] and r0["count"] == r1["count"] == 1
    assert r0["backend"] == "gloo" and r0["world"] == 2

    one = one_process_step(spec)
    names = [n for n, p in NCSNpp.from_config(load_config("train", SMALL)).named_parameters()
             if p.requires_grad]
    # the attention's k bias has a zero gradient in exact arithmetic: what
    # each side holds there is rounding noise (about 1e-9), so it is held to
    # the largest gradient's scale, and its weight, which Adam moves by the
    # noise's sign, to 2 lr
    zero = [n.endswith("NIN_1.b") for n in names]
    assert abs(r0["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"])
    for key in ("grads", "mu", "nu"):
        top = max(float(b.abs().max()) for b in one[key])
        for a, b, noise in zip(r0[key], one[key], zero):
            scale = top if noise else float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-5 * scale, key
    for key in ("params", "shadow"):
        for a, b, noise in zip(r0[key], one[key], zero):
            assert float((a - b).abs().max()) <= (2e-3 if noise else 1e-6), key

    # the one-process step against the JAX package's on the same global batch
    tx = jax_get_optimizer(jcfg)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                         opt_state=tx.init(params),
                         ema=jax_ema.init(params, decay=jcfg.model.ema_rate))
    jstep = jax.jit(jax_make_train_step(JRVESDE(0.01, 5, 1000), jmodel, tx))
    jstate, jloss = jstep(jstate, batch, labels, jax.random.PRNGKey(0), t=t, z=z)
    assert abs(one["loss"] - float(jloss)) <= 1e-5 * abs(float(jloss))
    theirs = state_dict_from_jax(jax.device_get(jstate.params))
    adam = next(st for st in jstate.opt_state if hasattr(st, "mu"))
    theirs_mu = state_dict_from_jax(jax.device_get(adam.mu))
    top = max(float(v.abs().max()) for v in theirs_mu.values())
    for name, ours, mu, noise in zip(names, one["params"], one["mu"], zero):
        # Adam's first moment is 0.1 of the gradient: held as the gradients above
        scale = top if noise else float(theirs_mu[name].abs().max())
        assert float((mu - theirs_mu[name]).abs().max()) <= 1e-5 * scale, name
        # A first Adam step moves a weight by lr g / (|g| + 1e-8): where |g| is
        # near 1e-8 a rounding-size change of g moves the step by a share of
        # lr (measured 0.0124 lr), and on the k bias by up to 2 lr
        # (test_torch_training.py::test_five_train_steps_match_jax_f32)
        err = float((ours - theirs[name]).abs().max())
        assert err <= (2e-3 if noise else 5e-5), (name, err)


def test_non_finite_rank_skips_the_update_on_every_rank(tmp_path, small_spec):
    """A NaN in rank 1's rows makes the averaged gradient non-finite: both
    ranks skip the update (parameters, moments and EMA unchanged), and only
    the step count advances, as one process on the global batch would."""
    spec = dict(small_spec[0], nan_rank=1)
    results = two_rank_step(tmp_path, spec)
    for r in results:
        assert not np.isfinite(r["loss"])
        assert r["step"] == 1 and r["count"] == 0 and r["ema_updates"] == 0
        assert all(float(m.abs().sum()) == 0 for m in r["mu"] + r["nu"])
    params0 = {n: p for n, p in spec["model_state"].items()}
    names = [n for n, p in NCSNpp.from_config(load_config("train", SMALL)).named_parameters()
             if p.requires_grad]
    for name, a, b in zip(names, results[0]["params"], results[1]["params"]):
        assert torch.equal(a, params0[name].float()) and torch.equal(b, a), name


# ---------------------------------------------------------------------------
# the split oracle, the trainer over two ranks, the dry run

def test_split_oracle_equals_one_device_lane_for_lane():
    """Eight round-2 lanes, one float64 iteration: split over two CPU parts
    (``device=["cpu", "cpu"]``; tile 7 rounded up to 8, four lanes a part)
    the result equals one device's (tile 7: a tile of 7 and one of 1),
    lane for lane and bit for bit."""
    physical = np.load(ROUND2)[:8]
    G, H = physical[:, 1:], physical[:, 0]
    kw = dict(max_iters=1, solver_mode="feasible", precision="df32", batch_tile=7)
    one = sg.refine_warmstarts_gpu(G, H, device="cpu", **kw)
    split = sg.refine_warmstarts_gpu(G, H, device=["cpu", "cpu"], **kw)
    assert set(one) == set(split)
    for k in one:
        np.testing.assert_array_equal(np.asarray(split[k]), np.asarray(one[k]), err_msg=k)


@pytest.mark.parametrize("n", [1, 4, 5, 11])
def test_fixed_batch_chunks_pad_and_reassemble(monkeypatch, n):
    """``_fixed_batch`` at a granule of 4 matrices: every call takes exactly
    4 (the last chunk padded), and the outputs (a tuple, with the
    factorisation's ``info``) come back in the leading shape [n, 2] equal
    to one call on the whole batch; one matrix is not SPD."""
    monkeypatch.setattr(sg, "_GRANULE", 4)
    g = torch.Generator().manual_seed(n)
    m = torch.randn(n, 2, 3, 3, generator=g, dtype=torch.float64)
    A = m @ m.transpose(-1, -2) + 3 * torch.eye(3, dtype=torch.float64)
    A[-1, 1] = -torch.eye(3, dtype=torch.float64)
    b = torch.randn(n, 2, 3, 1, generator=g, dtype=torch.float64)
    sizes = []

    def fn(a, rhs):
        sizes.append(a.shape[0])
        L, info = torch.linalg.cholesky_ex(a)
        return L, info, a @ rhs

    L, info, prod = sg._fixed_batch(fn, A, b)
    assert sizes == [4] * -(-2 * n // 4)
    L_ref, info_ref = torch.linalg.cholesky_ex(A)
    assert L.shape == (n, 2, 3, 3) and info.shape == (n, 2) and prod.shape == (n, 2, 3, 1)
    assert torch.equal(L, L_ref) and torch.equal(info, info_ref)
    assert int(info[-1, 1]) != 0 and int((info != 0).sum()) == 1
    assert torch.equal(prod, A @ b) and torch.equal(sg._bmm(A, b), A @ b)


def test_run_train_in_two_ranks_on_cpu(tmp_path):
    """``run_train`` under two gloo ranks: one run directory, one log (rank
    0's) with every step, checkpoints that restore, and each rank's
    snapshot samples at half the global batch."""
    pkl = data.make_synthetic_gto_pkl(str(tmp_path / "train.pkl"), n=40)
    args = ["+device=cpu", "model.nf=16", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
            "data.gto_mean=0", "data.gto_std=1", "training.batch_size=8",
            "eval.batch_size=8", "training.log_freq=1", "training.eval_freq=2",
            "training.snapshot_freq=2", "training.snapshot_freq_for_preemption=2",
            "sde.num_scales=4", "training.n_iters=2", f"data.pkl_path={pkl}"]
    outs = launch.run_ranks(["-m", "rdm_tpu_torch.run_train", *args], 2, env=RANK_ENV,
                            timeout=120, cwd=str(tmp_path))
    assert "rank 1 of 2" in outs[1]
    runs = os.listdir(tmp_path / "Training Runs")
    assert len(runs) == 1
    run = tmp_path / "Training Runs" / runs[0]
    with open(run / "logs") as f:
        log = f.read()
    assert log.count("training_loss") == 3 and log.count("evaluation_loss") == 2
    assert "rank 1" not in log
    ck = checkpoints.restore_checkpoint(str(run / "checkpoints" / "checkpoint_1.pth"))
    assert ck.step == 3 and ck.optimizer["count"] == 3
    for r in range(2):
        sample = np.load(run / "samples" / "iter_2" / f"sample_{r}.npy")
        assert sample.shape == (4, 9, 9, 1) and sample.dtype == np.uint8


def test_bench_in_two_ranks_on_cpu(monkeypatch):
    """``bench --n_devices 2`` under two ranks: rank 0 alone prints the JSON
    line, in traj/s of both ranks with ``n_devices``; without a launcher
    ``--n_devices 2`` names the command that starts the ranks."""
    args = ["-m", "rdm_tpu_torch.bench", "--device", "cpu", "--batch", "2", "--steps", "3",
            "--repeats", "1", "--n_devices", "2"]
    outs = launch.run_ranks(args, 2, env=RANK_ENV, timeout=120)
    lines = [[ln for ln in o.splitlines() if ln.startswith("{")] for o in outs]
    assert len(lines[0]) == 1 and lines[1] == []
    out = json.loads(lines[0][0])
    assert out["unit"] == "traj/s" and out["n_devices"] == 2 and out["value"] > 0
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    from rdm_tpu_torch import bench
    with pytest.raises(SystemExit, match="nproc_per_node 2"):
        bench.main(args[2:])


def test_dryrun_multichip_two_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    lines = dryrun_multichip(2, timeout=120)
    assert lines[0].startswith("dryrun_multichip(2): OK, loss=")
    assert "sampler OK, batch=4 sharded over 2 ranks" in lines[1]
    assert "oracle OK, batch=4 split over 2 devices" in lines[2]
