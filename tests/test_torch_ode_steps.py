"""Does the port's probability-flow ODE sampler take more steps than the JAX
package's?  (Slow: about 10 minutes on the CPU in float32, 25 in bfloat16;
``-s`` prints the counts.)

Both packages' ODE samplers run from the same injected ``z`` (the inset
uniform prior drawn with numpy) and the same labels on the flagship run's
EMA weights (``checkpoint_10.pth``), in float32 on the CPU, at batch 64 over
six seeds.  The step control magnifies the two networks' float32 rounding
differences (``tests/test_torch_ode.py::tiny``), so single runs take
different step sequences; the comparison is of the mean count against the
spread over seeds.  Measured on the CPU: JAX 252, 294, 273, 294, 266, 273;
the port 252, 280, 252, 252, 259, 259; paired difference -16.3 +- 5.9 (mean
+- standard error).  The port takes no more evaluations than the JAX
package: not a fault of the port.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.benchmark.common import LoadedModel as JaxLoadedModel
from rdm_tpu.models import create_model as jax_create_model
from rdm_tpu.models.registry import get_cf_score_fn as jax_cf_score_fn
from rdm_tpu.sampling import ode as jode
from rdm_tpu_torch.benchmark.common import LoadedModel
from rdm_tpu_torch.models.registry import get_cf_score_fn
from rdm_tpu_torch.sampling import ode

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(ROOT, "Training Runs", "2026.08.17_184657")
CHECKPOINT = os.path.join(RUN, "checkpoints", "checkpoint_10.pth")
BATCH = 64
SEEDS = range(6)


def inputs(seed):
    """The injected ``z`` (the inset uniform prior) and labels of a seed."""
    rng = np.random.default_rng(seed)
    z = (0.98 * rng.uniform(size=(BATCH, 1, 9, 9)) + 0.01).astype(np.float32)
    return z, rng.uniform(size=(BATCH, 1)).astype(np.float32)


def jax_nfe(jl, jmodel, seed):
    z, labels = inputs(seed)
    score = jax_cf_score_fn(jl.sde, jmodel, jl.ema_params, jnp.asarray(labels), 0.0)
    sampler = jode.get_ode_sampler(jl.sde, (BATCH, 9, 9, 1), eps=1e-3)
    _, nfe = jax.jit(lambda zz: sampler(score, jax.random.PRNGKey(0), z=zz))(
        jnp.asarray(z.transpose(0, 2, 3, 1)))
    return int(nfe)


def port_nfe(port, seed):
    z, labels = inputs(seed)
    sampler = ode.get_ode_sampler(port.sde, (BATCH, 1, 9, 9), eps=1e-3)
    _, nfe = sampler(get_cf_score_fn(port.sde, port.model, torch.from_numpy(labels), 0.0),
                     torch.Generator().manual_seed(0), z=torch.from_numpy(z))
    return nfe


def jax_loaded(precision):
    """The JAX package's flagship (``checkpoint_10.pth``, EMA weights) in
    ``precision``."""
    jl = JaxLoadedModel(RUN, checkpoint_file=CHECKPOINT)
    jl.cfg.model.precision = precision
    return jl, jax_create_model(jl.cfg)


def port_loaded(precision):
    return LoadedModel(RUN, checkpoint_file=CHECKPOINT, device="cpu",
                       model_overrides={"precision": precision})


def nfe_pair(jl, jmodel, port, seed):
    return jax_nfe(jl, jmodel, seed), port_nfe(port, seed)


@pytest.mark.slow
def test_ode_takes_no_more_steps_than_jax_in_float32():
    jl, jmodel = jax_loaded("float32")
    port = port_loaded("float32")
    pairs = np.array([nfe_pair(jl, jmodel, port, s) for s in SEEDS], float)
    assert (pairs % 7 == 0).all()
    diff = pairs[:, 1] - pairs[:, 0]
    se = diff.std(ddof=1) / np.sqrt(len(diff))
    print(f"NFE (jax, port) per seed {pairs.astype(int).tolist()}; port - jax "
          f"{diff.mean():.1f} +- {se:.1f}")
    # the port's mean is not above the JAX package's by more than two
    # standard errors of the paired difference, and the two means agree
    # within 10 % (the suspected fault was 13 % more at batch 1024)
    assert diff.mean() <= 2 * se, (pairs.tolist(), diff.mean(), se)
    assert abs(diff.mean()) <= 0.10 * pairs[:, 0].mean(), (pairs.tolist(), diff.mean())


JAX_BF16_SCRIPT = """
import json, sys
sys.path.insert(0, "tests")
import test_torch_ode_steps as t
jl, jmodel = t.jax_loaded("bfloat16")
print(json.dumps(t.jax_nfe(jl, jmodel, int(sys.argv[1]))))
"""
BF16_SEEDS = range(3)


@pytest.mark.slow
def test_ode_bf16_counts_of_both_packages():
    """The same comparison in bfloat16 at batch 64, over three seeds; the
    JAX package in one subprocess a seed with ``xla_allow_excess_precision``
    off (its Pallas attention in interpret mode), as the CPU tests hold its
    bf16 kernels.  (About 25 minutes on 4 cores.)

    In bfloat16 the step control sits at a floor set by the score's
    rounding noise: each package takes nearly the same count for every
    seed, where float32 counts vary by seed.  Measured on the CPU: JAX 2394,
    2408, 2387; the port 1645, 1673, 1673.  So the port's bf16 count is no
    fault of the port: under the same rounding rule the JAX package's floor
    lies higher.  (The JAX package's record on a TPU, 1,491 NFE at batch
    1024 against the port's 1,680 on the card, comes from the TPU's own
    rounding, which allows excess precision by default.)"""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    procs = [subprocess.Popen([sys.executable, "-c", JAX_BF16_SCRIPT, str(s)], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for s in BF16_SEEDS]
    port = port_loaded("bfloat16")
    ours = np.array([port_nfe(port, s) for s in BF16_SEEDS], float)
    theirs = []
    for proc in procs:
        out, err = proc.communicate(timeout=3600)
        assert proc.returncode == 0, err[-4000:]
        theirs.append(json.loads(out.strip().splitlines()[-1]))
    theirs = np.array(theirs, float)
    print(f"bf16 NFE per seed: jax {theirs.astype(int).tolist()}, "
          f"port {ours.astype(int).tolist()}")
    assert (ours % 7 == 0).all() and (theirs % 7 == 0).all()
    # each package within 5 % of its own mean on every seed: a floor
    for counts in (ours, theirs):
        assert counts.max() - counts.min() <= 0.05 * counts.mean(), counts.tolist()
    # the port's floor is not above the JAX package's
    assert ours.mean() <= theirs.mean(), (ours.tolist(), theirs.tolist())
