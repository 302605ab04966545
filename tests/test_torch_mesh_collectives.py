"""The port's mesh, partition specs and collectives against the JAX
package's (``common/mesh.py``, ``parallel/collectives.py``).

The spec helpers run in this process on meshes of rank ids. Each
collective runs on 4 gloo ranks (``launch.RankPool``, one pool for the
module), the JAX one inside ``shard_map`` over 4 of the 8 virtual CPU
devices, both on the same numpy input: its value, and the gradient of
``sum(op(x) * c)``, which decides each transpose (the port's rank loss
is its part of the global loss, as JAX splits a replicated output's
cotangent over the devices). Tolerance: f32 sums of 4 terms in another
order, atol 1e-6.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from deeplearning4j_tpu.common import mesh as jmesh
from deeplearning4j_tpu.nn import sharding as jsharding
from deeplearning4j_tpu.parallel import collectives as jcoll

from deeplearning4j_tpu_torch.common import mesh as tmesh
from deeplearning4j_tpu_torch.parallel import collectives as tcoll

from torch_parallel_cases import Ranks

ATOL = 1e-6
CONFIGS = [dict(), dict(tensor=2), dict(data=2, seq=2), dict(fsdp=2, pipe=2),
           dict(data=2, tensor=2, seq=2), dict(data=4, tensor=2)]


@pytest.fixture(scope="module")
def ranks():
    r = Ranks(4)
    yield r
    r.close()


def _norm(spec):
    entries = list(spec)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


class TestMesh:
    @pytest.mark.parametrize("cfg", CONFIGS, ids=str)
    @pytest.mark.parametrize("n", [4, 8])
    def test_resolve_and_shape(self, cfg, n):
        jc, tc = jmesh.MeshConfig(**cfg), tmesh.MeshConfig(**cfg)
        try:
            want = jc.resolve(n)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(" ")[0]):
                tc.resolve(n)
            return
        assert tc.resolve(n) == want
        jm = jmesh.make_mesh(jc, devices=jax.devices()[:n])
        tm = tmesh.make_mesh(tc, devices=range(n), device="cpu")
        assert tm.shape == dict(jm.shape)
        assert tm.axis_names == tuple(jm.axis_names)
        assert tm.devices.shape == jm.devices.shape

    def test_bad_mesh_raises(self):
        with pytest.raises(ValueError) as je:
            jmesh.make_mesh(jmesh.MeshConfig(data=3, tensor=3))
        with pytest.raises(ValueError) as te:
            tmesh.make_mesh(tmesh.MeshConfig(data=3, tensor=3),
                            devices=range(8), device="cpu")
        assert str(te.value) == str(je.value)

    def test_serving_mesh_shape_and_desc(self):
        jm = jmesh.serving_mesh(2, devices=jax.devices()[:8])
        tm = tmesh.serving_mesh(2, devices=range(8), device="cpu")
        assert tmesh.mesh_shape(tm) == jmesh.mesh_shape(jm)
        assert tmesh.mesh_shape(None) is None
        for spec in (None, (("data",), None), ("model",)):
            js = None if spec is None else JP(*spec)
            ts = None if spec is None else tmesh.P(*spec)
            assert tmesh.spec_desc(ts) == jmesh.spec_desc(js)
        with pytest.raises(ValueError) as je:
            jmesh.validate_mesh(jm, ("data", "tensor"))
        with pytest.raises(ValueError) as te:
            tmesh.validate_mesh(tm, ("data", "tensor"))
        assert str(te.value) == str(je.value)

    def test_serving_param_shardings_match(self):
        jm = jmesh.serving_mesh(4, devices=jax.devices()[:8])
        tm = tmesh.serving_mesh(4, devices=range(8), device="cpu")
        tree = {"a": np.zeros((8, 12)), "b": np.zeros((3,)),
                "c": np.zeros((6, 5)), "d": np.zeros((4, 4, 8))}
        for spec in (None, (None, "model")):
            js = None if spec is None else JP(*spec)
            ts = None if spec is None else tmesh.P(*spec)
            want = jax.tree_util.tree_map(
                lambda s: _norm(s.spec), jmesh.param_shardings(jm, tree, js))
            got = {k: _norm(v) for k, v in
                   tmesh.param_shardings(tm, tree, ts).items()}
            assert got == want
        assert tuple(tmesh.data_sharding(tm)) == \
            tuple(jmesh.data_sharding(jm).spec)

    def test_no_group_means_one_rank(self):
        m = tmesh.make_mesh(device="cpu")
        assert m.shape["data"] == 1 and m.group("data") is None
        assert tcoll.transport(m.group("data"), "cpu") == "local"
        with pytest.raises(RuntimeError, match="mesh"):
            tcoll.all_reduce_sum(np.zeros(2), "data")


SHAPES = [(8, 6), (6, 8), (3, 4, 8), (16,), (5, 3), (2, 2, 2, 4), ()]
SPECS = [(), ("tensor",), (None, "tensor"), (("data", "fsdp"),),
         ("fsdp", None, "tensor"), ("data", "model")]


class TestSpecs:
    @pytest.mark.parametrize("cfg", [dict(data=2, fsdp=2, tensor=2),
                                     dict(data=4, tensor=2),
                                     dict(fsdp=4, tensor=2)], ids=str)
    def test_spec_helpers_match(self, cfg):
        jm = jmesh.make_mesh(jmesh.MeshConfig(**cfg))
        tm = tmesh.make_mesh(tmesh.MeshConfig(**cfg), devices=range(8),
                             device="cpu")
        for shape in SHAPES:
            a = np.zeros(shape, np.float32)
            assert tuple(tmesh.zero1_spec(tm, a)) == \
                tuple(jmesh.zero1_spec(jm, a))
            for axis in ("tensor", "data"):
                assert _norm(tmesh.naive_param_spec(a, tm, axis)) == \
                    _norm(jmesh.naive_param_spec(a, jm, axis))
            for spec in SPECS:
                assert tmesh.spec_fits(a, tmesh.P(*spec), tm) == \
                    jmesh.spec_fits(a, JP(*spec), jm), (shape, spec)
                if "model" in spec:
                    continue
                got = tmesh.valid_spec(tm, tmesh.P(*spec), shape)
                want = jsharding.valid_sharding(jm, JP(*spec), shape).spec
                assert _norm(got) == _norm(want), (shape, spec)

    def test_layer_leaf_rules_match(self):
        from deeplearning4j_tpu_torch.nn import sharding as tsharding
        for key, shape in (("W", (8, 6)), ("b", (6,)), ("state_mean", (6,)),
                           ("W", (3, 3, 4, 8)), ("W", (2, 3, 3, 4, 8))):
            a = np.zeros(shape)
            assert tuple(tsharding.default_leaf_spec(key, a)) == \
                tuple(jsharding.default_leaf_spec(key, a))
            assert tuple(tsharding.conv_leaf_spec(key, a)) == \
                tuple(jsharding.conv_leaf_spec(key, a))

    def test_zero1_layout_on_ranks(self, ranks):
        shapes = [(8, 3), (6, 4), (4,), (3,), (12, 2, 2)]
        out = ranks.run("zero1_layout", shapes)
        jm = jmesh.make_mesh(jmesh.MeshConfig(data=2, fsdp=2),
                             devices=jax.devices()[:4])
        for specs, local, back in out:
            assert specs == [repr(tmesh.P(*jmesh.zero1_spec(
                jm, np.zeros(s)))) for s in shapes]
            assert local == [(s[0] // 4,) + s[1:] if s[0] % 4 == 0 else s
                             for s in shapes]
            assert back == shapes

    def test_mesh_layout_on_ranks(self, ranks):
        out = ranks.run("mesh_layout", {"data": 2, "tensor": 2})
        jm = jmesh.make_mesh(jmesh.MeshConfig(data=2, tensor=2),
                             devices=jax.devices()[:4])
        ids = np.vectorize(lambda d: d.id)(jm.devices).reshape(2, 2)
        for r, o in enumerate(out):
            d, t = map(int, np.argwhere(ids == r)[0])
            assert (o["coords"]["data"], o["coords"]["tensor"]) == (d, t)
            assert o["data"] == [int(ids[i, t]) for i in range(2)]
            assert o["tensor"] == [int(ids[d, j]) for j in range(2)]
            assert o["dp"] == [0, 1, 2, 3] and o["index"] == r


OPS = {
    # op: (JAX body, JAX out spec is replicated)
    "psum": (lambda x: jcoll.all_reduce_sum(x, "data"), True),
    "pmean": (lambda x: jcoll.all_reduce_mean(x, "data"), True),
    "all_gather": (lambda x: jcoll.all_gather(x, "data", gather_axis=1),
                   True),
    "psum_scatter": (lambda x: jcoll.reduce_scatter(x, "data"), False),
    "ppermute": (lambda x: jcoll.ppermute_next(x, "data"), False),
    "all_to_all": (lambda x: jcoll.all_to_all(x, "data", 1, 0), False),
    "broadcast": (lambda x: jcoll.broadcast_from(x, "data", root=2), True),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_collective_value_and_grad_match_jax(ranks, name):
    body, replicated = OPS[name]
    mesh = jmesh.make_mesh(jmesh.MeshConfig(data=4),
                           devices=jax.devices()[:4])
    spec = JP(("data", "fsdp", "tensor", "seq", "pipe"))
    fn = jmesh.shard_map(body, mesh=mesh, in_specs=spec,
                         out_specs=JP() if replicated else spec)
    rs = np.random.RandomState(0)
    x = rs.randn(16, 8).astype(np.float32)
    out = np.asarray(fn(jnp.asarray(x)))
    c = rs.randn(*out.shape).astype(np.float32)
    grad = np.asarray(jax.grad(lambda v: jnp.sum(fn(v) * c))(jnp.asarray(x)))
    for value, g, transport in ranks.run("collective", name, x, c):
        assert transport == "gloo"
        np.testing.assert_allclose(value, out, atol=ATOL, rtol=0)
        np.testing.assert_allclose(g, grad, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shift", [0.0, 100.0])
def test_batch_moments_match_global_batch(ranks, shift):
    """Batch-norm statistics inside a batch context: one collective per
    call, the global batch's mean and biased variance and their
    gradients, also where the mean dwarfs the spread."""
    rs = np.random.RandomState(1)
    x = (rs.randn(16, 3, 5) + shift).astype(np.float32)
    c1, c2 = (rs.randn(3).astype(np.float32) for _ in range(2))

    def f(v):
        return jnp.mean(v, axis=(0, 2)), jnp.var(v, axis=(0, 2))
    mean, var = map(np.asarray, f(jnp.asarray(x)))
    grad = np.asarray(jax.grad(lambda v: jnp.sum(f(v)[0] * c1)
                               + jnp.sum(f(v)[1] * c2))(jnp.asarray(x)))
    for m, v, g in ranks.run("batch_moments", x, c1, c2):
        np.testing.assert_allclose(m, mean, atol=ATOL * max(shift, 1.0),
                                   rtol=0)
        np.testing.assert_allclose(v, var, atol=ATOL, rtol=1e-5)
        np.testing.assert_allclose(g, grad, atol=ATOL, rtol=1e-5)
