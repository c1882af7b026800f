"""The flagship topology through both packages, at reduced width.

``build_glow((1, 28, 28))`` with L=2 blocks, K=2 steps and coupling width
16 keeps the flagship's real solve shapes, (4, 14, 14) and (8, 7, 7). JAX
initialises the params (seed 0); ``params_from_jax`` carries them over;
ActNorm's data init and then log p(x) run in both packages on the same
batch with the same injected dequantization noise u. Dequantization adds
x + u with ldj 0, so both sides run the layers after it on x + u.

Tolerances: rtol 1e-5 on log p(x) (a sum over 784 dims, about -3e3) and
atol 1e-4 on z; ActNorm params to rtol 1e-4, atol 1e-5 (statistics after
up to 20 float32 layers).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
from inverse_flow_tpu_torch.bridge import params_from_jax
from inverse_flow_tpu_torch.data.loader import ArrayLoader
from inverse_flow_tpu_torch.layers import Flow
from inverse_flow_tpu_torch.models.glow import build_glow
from inverse_flow_tpu_torch.ops import fused_chain
from inverse_flow_tpu_torch.train.config import ExperimentConfig
from inverse_flow_tpu_torch.train.experiment import Experiment

KW = dict(num_blocks=2, block_size=2, coupling_width=16)
B = 8


@pytest.fixture(scope="module")
def flows():
    jflow = jax_build_glow((1, 28, 28), **KW)
    jparams = jax.jit(lambda key: jflow.init(key, (1, 28, 28))[0])(
        jax.random.PRNGKey(0))
    tflow = build_glow((1, 28, 28), **KW, device="cpu")
    params_from_jax(tflow, jparams)
    rs = np.random.RandomState(0)
    x = rs.randint(0, 256, (B, 1, 28, 28)).astype(np.float32)
    u = rs.uniform(0, 1, x.shape).astype(np.float32)
    return jflow, jparams, tflow, x, u


def test_flagship_topology_matches_jax(flows):
    jflow, jparams, tflow, x, u = flows
    assert len(tflow.layers) == len(jflow.layers) == 9

    # data init and scoring after dequantization, on the same x + u
    jsub = JaxFlow(jflow.base_distribution, jflow.layers[1:])
    jnew = jax.jit(jsub.data_init)(jparams[1:], jnp.asarray(x + u))
    tsub = Flow(tflow.base_distribution, tflow.layers[1:])
    tsub.data_init(torch.from_numpy(x + u))
    for i in (5, 8):                              # the RepeatedBlocks
        for name in ("translation", "log_scale"):    # (K, C) each
            ours = tflow.layers[i].steps[0].get_parameter(name)
            ref = jnew[i - 1]["steps"][0][name]
            np.testing.assert_allclose(ours.detach().numpy(),
                                       np.asarray(ref), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{i} {name}")

    zj, lpj = jax.jit(jsub.forward)(jnew, jnp.asarray(x + u))
    with torch.no_grad():
        zt, lpt = tsub(torch.from_numpy(x + u))
        _, ldj0 = tflow.layers[0](torch.from_numpy(x),
                                  noise=torch.from_numpy(u))
    assert zt.shape == (B, 8, 7, 7)
    assert not ldj0.any()
    assert np.isfinite(lpt.numpy()).all()
    np.testing.assert_allclose(lpt.numpy(), np.asarray(lpj), rtol=1e-5)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-4,
                               rtol=0)


def test_experiment_eval_epoch_bpd(flows):
    """The scoring entry point: data init on the first batch, then the
    mean log p(x) over the split, the last partial batch included, with
    noise drawn from the seeded generator; the chain kernel is never
    launched on the CPU."""
    _, _, tflow, x, _ = flows
    data = np.concatenate([x, x[:3]])             # batches of 4, 4, 3
    val = ArrayLoader(data, 4, drop_last=False)
    exp = Experiment(copy.deepcopy(tflow), ArrayLoader(data, 4), val, val,
                     ExperimentConfig(seed=0), device="cpu")
    before = fused_chain.chain_phases.launches
    logpx = exp.eval_epoch(val)
    assert fused_chain.chain_phases.launches == before
    bpd = exp.to_bpd(logpx)
    assert np.isfinite(bpd) and 0 < bpd < 32

    flow = copy.deepcopy(tflow)
    gen = torch.Generator().manual_seed(0)
    batches = [torch.from_numpy(b) for b in val]
    flow.data_init(batches[0], gen)
    with torch.no_grad():
        lp = torch.cat([flow.cheap_log_prob(b, gen) for b in batches])
    assert lp.shape == (11,)
    np.testing.assert_allclose(logpx, lp.mean().item(), rtol=1e-6)
