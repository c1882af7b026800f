"""The port's (data, model) mesh and the coupling nets' tensor parallelism
against the JAX package's (``inverse_flow_tpu/parallel/mesh.py``,
``tests/test_experiment.py::test_coupling_tp_sharding_matches_replicated``),
on the CPU.

(a) ``coupling_tp_shardings``: the sharded dimension of every parameter
equals JAX's on the same flows, name by name through the bridge; (b) the
guards; (c) spawned gloo worlds of 4 and 2 ranks at (2, 2) and (1, 2)
meshes (``tests/torch_workers.py:mesh_cases``): the sharded step of the
JAX test's Glow (coupling nets checkpointed and not, float32 and bf16)
and of a ``BSplineCoupling`` flow against JAX's replicated and sharded
losses and ``jax.grad``, and against the port's one-process step; (d)
without a group the nets are today's, bit for bit.

Weights: JAX's init (seed 0) with every ``w3``, ``b3`` and ``logs3``
moved by normal noise of std 0.05 (at init they are 0, the net's output
is 0 and ``w1``/``w2`` get no gradient), carried over with
``params_from_jax``. The Glows run after dequantization on x + u.

Tolerances: the loss against JAX rtol 1e-5 (the JAX test's); the gathered
gradients against ``jax.grad`` atol 1e-5 rtol 1e-4 (``test_torch_
parallel.py``'s), for the ``BSplineCoupling`` flow atol 1e-6 of each
tensor's largest entry (its gradients reach 133 in ``w3``, and entries
near 1e-3 of that tensor move by 1.4e-5 when the sums split over ranks);
against the port's one-process step the loss and the global norm rtol
1e-6, the gradients 1e-6 of each tensor's largest entry (the same float32
sums split over ranks; 3.3e-7 seen), the weights after one SGD step atol
1e-6 (lr 1e-3, momentum 0.9, the clip at 1000 active: a step linear in
the gradient, where Adam's first step, ``g / (|g| + 1e-8)``, would turn
those splits into lr-sized moves of the entries near 0),
``Flow.sample`` and ``reconstruct`` ``1e-5 * max(1, max|x|)`` (the
inverses' rule: a steep spline's inverse moves a net's float32 splits by
up to 1.3e-5 at |x| near 10); the bf16 nets within 0.01 bpd
(``tests/test_torch_bf16.py``'s bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_workers as w
from inverse_flow_tpu.distributions import GaussianPrior as JaxGaussian
from inverse_flow_tpu.layers import ActNorm as JaxActNorm
from inverse_flow_tpu.layers import BSplineCoupling as JaxBSplineCoupling
from inverse_flow_tpu.layers import Flow as JaxFlow
from inverse_flow_tpu.layers import RepeatedBlock as JaxRepeatedBlock
from inverse_flow_tpu.models.glow import build_glow as jax_build_glow
from inverse_flow_tpu.parallel import mesh as jmesh
from inverse_flow_tpu_torch import parallel as dp
from inverse_flow_tpu_torch.bridge import params_from_jax
from inverse_flow_tpu_torch.layers import BSplineCoupling, Coupling
from inverse_flow_tpu_torch.train.optim import apply_grads, make_optimizer

B = 8
SEED = 0
PERTURB = 0.05
TIMEOUT = 120.0
CASES = ("glow", "glow_no_remat", "glow_bf16", "bspline")


def _jax_flow(name):
    if name.startswith("glow"):
        return jax_build_glow(
            w.TINY, step_kind="inv_conv_no_pad", num_blocks=1, block_size=2,
            coupling_width=6 if name == "glow_width6" else 16, actnorm=True,
            split_prior=True, activation="SLR",
            coupling_remat=name != "glow_no_remat",
            coupling_dtype="bfloat16" if name == "glow_bf16" else "float32")
    step = (JaxActNorm(4), JaxBSplineCoupling(w.SPLINE_SIZE, width=16))
    if name == "bspline_block":
        return JaxFlow(JaxGaussian(w.SPLINE_SIZE),
                       [JaxRepeatedBlock(step, 3)])
    return JaxFlow(JaxGaussian(w.SPLINE_SIZE), list(step))


def _jax_params(jflow, shape):
    params, _ = jflow.init(jax.random.PRNGKey(SEED), shape)
    rs = np.random.RandomState(1)

    def moved(path, leaf):
        if getattr(path[-1], "key", None) in ("w3", "b3", "logs3"):
            return leaf + PERTURB * rs.standard_normal(leaf.shape).astype(
                np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(moved, params)


def _jax_dims(jparams, mesh):
    """JAX's sharded dimension of every parameter, by the port's name."""
    dims = {}
    for i, tree in enumerate(jmesh.coupling_tp_shardings(jparams, mesh)):
        for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                            for k in path)
            spec = tuple(s.spec)
            dims[f"layers.{i}.{name}"] = (spec.index("model")
                                          if "model" in spec else None)
    return dims


@pytest.mark.parametrize("name, shape", [
    ("glow", (4, 2)), ("bspline", (4, 2)), ("bspline_block", (4, 2)),
    ("glow_width6", (2, 4))])
def test_shardings_match_jax(name, shape):
    """(a) The port's rule gives JAX's sharded dimension for every
    parameter: the stacked ``RepeatedBlock`` weights on 1 and 2, a
    ``BSplineCoupling``'s on 0 and 1, and a width of 6 that a model axis
    of 4 does not divide stays replicated."""
    jflow = _jax_flow(name)
    size = w.TINY if name.startswith("glow") else w.SPLINE_SIZE
    jparams = _jax_params(jflow, size)
    flow = params_from_jax(w.MESH_FLOWS[name](), jparams)
    ours = dp.coupling_tp_shardings(
        flow, dp.Mesh(("data", "model"), dict(zip(("data", "model"),
                                                  shape))))
    theirs = _jax_dims(jparams, jmesh.make_mesh_2d(*shape))
    assert ours == {k: theirs[k] for k in ours} and set(ours) == set(theirs)
    sharded = {k: v for k, v in ours.items() if v is not None}
    if name == "glow_width6":
        assert not sharded
    else:
        stacked = name != "bspline"
        assert sharded and all(
            v == int(stacked) + (k.endswith("w2")) for k, v in
            sharded.items())
    # no model axis: every parameter replicated
    assert set(dp.coupling_tp_shardings(flow, dp.make_mesh()).values()) \
        == {None}


def test_mesh_guards_without_a_group():
    """(b) ``test_mesh_guards``: without a process group the world is one
    rank, so the 1-D mesh and the 1 x 1 mesh exist and anything larger
    raises naming what is available."""
    one = dp.make_mesh(n_devices=1)
    assert one.size == 1 and one.coords == {"data": 0}
    assert dp.make_mesh().size == 1
    with pytest.raises(ValueError, match="available"):
        dp.make_mesh(n_devices=2)
    with pytest.raises(ValueError, match="available"):
        dp.make_mesh_2d(1, 2)
    grid = dp.make_mesh_2d(1, 1)
    assert grid.coords == {"data": 0, "model": 0}
    assert grid.data_group is None and grid.model_group is None


def _jax_refs(name, inp, mesh):
    """JAX's weights of case ``name`` (as the port's numpy state), its
    replicated and ``mesh``-sharded losses on ``inp`` (after a Glow's
    dequantization) and ``jax.grad`` by the port's names."""
    glow = name.startswith("glow")
    jflow = _jax_flow(name)
    jparams = _jax_params(jflow, w.TINY if glow else w.SPLINE_SIZE)
    state = w.numpy_state(params_from_jax(w.MESH_FLOWS[name](), jparams))
    jbody, jp = ((JaxFlow(jflow.base_distribution, jflow.layers[1:]),
                  jparams[1:]) if glow else (jflow, jparams))

    def loss(p, v):
        return -jnp.mean(jbody.forward(p, v)[1])

    v = jnp.asarray(inp)
    jloss = float(jax.jit(loss)(jp, v))
    psh = jmesh.coupling_tp_shardings(jp, mesh)
    jsharded = float(jax.jit(loss)(
        jax.tree_util.tree_map(jax.device_put, jp, psh),
        jax.device_put(v, NamedSharding(mesh, P("data", None, None, None)))))
    jgrads = jax.jit(jax.grad(loss))(jp, v)
    jgrads = w.numpy_state(params_from_jax(
        w.MESH_FLOWS[name](), ([{}] if glow else []) + list(jgrads)))
    return state, jloss, jsharded, jgrads


@pytest.fixture(scope="module")
def refs():
    """For each case: the weights, the input, JAX's replicated and
    (4, 2)-sharded losses and ``jax.grad`` (by the port's names), and the
    port's one-process step (loss, gradients, norm, weights after one
    SGD step, ``Flow.sample`` of ``z`` and ``reconstruct``)."""
    rs = np.random.RandomState(0)
    x = rs.randint(0, 256, (B,) + w.TINY).astype(np.float32)
    xu = x + rs.uniform(0, 1, x.shape).astype(np.float32)
    spline_x = (3 * rs.standard_normal((B,) + w.SPLINE_SIZE)).astype(
        np.float32)
    jmesh_ = jmesh.make_mesh_2d(4, 2)
    cfg = w.config("/nonexistent", warmup_epochs=0, optimizer_name="SGD",
                   sgd_momentum=0.9, grad_clip_norm=1000.0)
    out = {"cfg": cfg}
    jax_refs = {}
    for name in CASES:
        glow = name.startswith("glow")
        inp = xu if glow else spline_x
        # the Glows share JAX's params and values: JAX's checkpoint and the
        # port's bf16 nets change no name, and the bf16 case is held to
        # float32 by bpd alone
        jname = "glow" if glow else name
        if jname not in jax_refs:
            jax_refs[jname] = _jax_refs(jname, inp, jmesh_)
        state, jloss, jsharded, jgrads = jax_refs[jname]
        flow = w.mesh_flow(name, state)
        net = w.body(flow)
        z = rs.standard_normal((4,) + tuple(net.base_distribution.size)
                               ).astype(np.float32)
        sample = net.sample(4, noise={"base": torch.from_numpy(z)}).numpy()
        recon = net.reconstruct(torch.from_numpy(inp),
                                torch.Generator().manual_seed(0)).numpy()
        params = [p for p in flow.parameters() if p.requires_grad]
        one_loss = -net(torch.from_numpy(inp))[1].mean()
        one_loss.backward()
        grads = {k: p.grad.numpy().copy()
                 for k, p in flow.named_parameters()}
        norm = float(torch.nn.utils.clip_grad_norm_(params, float("inf")))
        optimizer, scheduler = make_optimizer(cfg, params, 1)
        apply_grads(cfg, optimizer, scheduler, params)
        out[name] = dict(state=state, x=inp, z=z, jloss=jloss,
                         jsharded=jsharded, jgrads=jgrads,
                         loss=one_loss.item(), grads=grads, norm=norm,
                         params=w.numpy_state(flow), sample=sample,
                         recon=recon)
    out["noise_x"] = x
    return out


def _noise_reference(refs, n_data):
    """The whole Glow's data init on x with the shared seed, then the mean
    of one-process losses on each data row's slice with that row's
    generator."""
    flow = w.mesh_flow("glow", refs["glow"]["state"])
    x = torch.from_numpy(refs["noise_x"])
    flow.data_init(x, torch.Generator().manual_seed(SEED))
    losses = []
    with torch.no_grad():
        for d in range(n_data):
            gen = torch.Generator().manual_seed(dp.rank_seed(SEED, d))
            losses.append(float(-flow(dp.shard_batch(x, d, n_data), gen)[1]
                                .mean()))
    return np.mean(losses), losses


def _close_by_max(a, b, rtol):
    """|a - b| within ``rtol`` of b's largest entry."""
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rtol * max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_mesh_step_matches_jax_and_one_process(shape, refs, tmp_path):
    """(b, c) A world of ``n_data * n_model`` gloo ranks: the guards and
    where the mesh puts each rank; for each case the sharded step against
    JAX (replicated and sharded loss, ``jax.grad``) and the port's
    one-process step (loss, gradients, global norm, weights after
    ``apply_grads`` with an active clip), ``Flow.sample`` and
    ``reconstruct``; the replicas bitwise equal (replicated weights on
    every rank, each shard in its data group); each data row's own noise;
    the bf16 nets within 0.01 bpd."""
    n_data, n_model = shape
    size = n_data * n_model
    cases = [tuple(refs[name][k] for k in ("state", "x", "z"))
             for name in CASES]
    out = dp.spawn(w.mesh_cases, size, f"file://{tmp_path}/pg",
                   args=(shape, [(name,) + c for name, c in zip(CASES, cases)],
                         refs["cfg"],
                         ("glow", refs["glow"]["state"], refs["noise_x"],
                          SEED)), timeout=TIMEOUT)
    for rank, r in enumerate(out):
        d, m = divmod(rank, n_model)
        assert r["coords"] == {"data": d, "model": m}
        assert r["data_ranks"] == [e * n_model + m for e in range(n_data)]
        assert r["model_ranks"] == [d * n_model + e for e in range(n_model)]
        g = r["guards"]
        assert len(g["errors"]) == 2 and all("available" in e
                                             for e in g["errors"])
        assert g["one"] == (size, {"data": rank})
        inside = rank < 2
        assert g["row"] == (2, {"data": 0, "model": rank} if inside else
                            None, [0, 1] if inside else None)
    dim = np.prod(w.TINY) * np.log(2.0)
    for name in CASES:
        ref = refs[name]
        for r in out:
            c = r[name]
            assert c["equal"]
            assert c["shards"] and all(k.rsplit(".", 1)[1] in ("w1", "w2")
                                       for k in c["shards"])
            for k, v in c["params"].items():
                np.testing.assert_allclose(v, out[0][name]["params"][k],
                                           rtol=0, atol=0)
        c = out[0][name]
        if name == "glow_bf16":
            # bf16 nets: within 0.01 bpd of float32 (JAX) and of the
            # one-process bf16 step
            for other in (refs["glow"]["jloss"], ref["loss"]):
                assert abs(c["loss"] - other) / dim <= 0.01
            continue
        np.testing.assert_allclose(c["loss"], ref["jloss"], rtol=1e-5)
        np.testing.assert_allclose(c["loss"], ref["jsharded"], rtol=1e-5)
        np.testing.assert_allclose(c["loss"], ref["loss"], rtol=1e-6)
        np.testing.assert_allclose(c["norm"], ref["norm"], rtol=1e-6)
        assert set(c["grads"]) == set(ref["jgrads"]) == set(ref["grads"])
        for k, v in c["grads"].items():
            j = ref["jgrads"][k]
            atol = 1e-6 * np.abs(j).max() if name == "bspline" else 1e-5
            np.testing.assert_allclose(v, j, atol=atol, rtol=1e-4,
                                       err_msg=f"{name} {k}")
            _close_by_max(v, ref["grads"][k], 1e-6)
        for k, v in c["params"].items():
            np.testing.assert_allclose(v, ref["params"][k], rtol=0,
                                       atol=1e-6, err_msg=f"{name} {k}")
        for what in ("sample", "recon"):
            np.testing.assert_allclose(
                c[what], ref[what], rtol=0,
                atol=1e-5 * max(1.0, np.abs(ref[what]).max()),
                err_msg=f"{name} {what}")
    mean, losses = _noise_reference(refs, n_data)
    for r in out:
        np.testing.assert_allclose(r["noise_loss"], mean, rtol=1e-6)
    if n_data > 1:
        assert losses[0] != losses[1]


def _parent_coupling_net(layer, p, x1):
    """``Coupling._net`` as it was before the mesh."""
    dt = layer.compute_dtype
    h = F.relu(F.conv2d(x1.to(dt), p["w1"].to(dt), padding=1))
    h = F.relu(F.conv2d(h, p["w2"].to(dt)))
    if dt == torch.float32:
        h = F.conv2d(h, p["w3"], p["b3"], padding=1)
    else:
        h = F.conv2d(h, p["w3"].to(dt), padding=1).float()
        h = h + p["b3"].reshape(1, -1, 1, 1)
    return h * torch.exp(p["logs3"] * layer.logscale_factor).reshape(
        1, -1, 1, 1)


def _parent_bspline_net(layer, p, x1):
    """``BSplineCoupling._net`` as it was before the mesh."""
    h = F.relu(F.conv2d(x1, p["w1"], padding=1))
    h = F.relu(F.conv2d(h, p["w2"]))
    h = F.conv2d(h, p["w3"], p["b3"], padding=1)
    return h * torch.exp(p["logs3"] * layer.logscale_factor).reshape(
        1, -1, 1, 1)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "bspline"])
def test_net_without_a_group_is_unchanged(kind):
    """(d) Without a model group each coupling net is bitwise today's,
    forward and gradients."""
    g = torch.Generator().manual_seed(0)
    if kind == "bspline":
        layer, parent = BSplineCoupling((4, 4, 4), width=16, generator=g,
                                        device="cpu"), _parent_bspline_net
    else:
        layer, parent = Coupling((4, 4, 4), width=16, compute_dtype=kind,
                                 generator=g, device="cpu"), \
            _parent_coupling_net
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    assert layer.model_group is None
    x1 = torch.randn((3, 2, 4, 4), generator=g)
    params = list(layer.parameters())
    outs = []
    for net in (layer._net, lambda p, x: parent(layer, p, x)):
        h = net(layer.own_params(), x1)
        outs.append((h, torch.autograd.grad(h.square().sum(), params)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_one_by_one_mesh_is_the_identity():
    """(d) A 1 x 1 mesh shards nothing: the same parameter objects, no
    group, the same log p(x) bit for bit, and ``gather_shardings`` is the
    state dict."""
    flow = w.tp_glow()
    before = dict(flow.named_parameters())
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 256, (4,) + w.TINY).astype(np.float32))
    ref = w.body(flow)(x)[1]
    mesh = dp.make_mesh_2d(1, 1)
    specs = dp.coupling_tp_shardings(flow, mesh)
    assert any(v is not None for v in specs.values())
    assert dp.apply_shardings(flow, specs, mesh) is flow
    assert all(p is before[k] for k, p in flow.named_parameters())
    assert not any(dp.is_sharded(p) for p in flow.parameters())
    assert all(getattr(l, "model_group", None) is None
               for l in flow.modules())
    assert torch.equal(w.body(flow)(x)[1], ref)
    gathered = dp.gather_shardings(flow, specs, mesh)
    assert gathered.keys() == flow.state_dict().keys()
    assert all(torch.equal(v, flow.state_dict()[k])
               for k, v in gathered.items())
