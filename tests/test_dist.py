"""Multi-device sharding tests on the virtual 8-device CPU mesh
(SURVEY.md section 4: sharding logic testable without a pod)."""

import os
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_rt.bvh import build_sbvh, flatten_bvh
from tpu_rt.core.types import make_rays, pad_rays
from tpu_rt.diff.shading import render_image_diff
from tpu_rt.dist import grad_step_sharded, make_ray_mesh, render_diff_sharded, shard_rays, trace_sharded
from tpu_rt.dist.sharding import replicate_bvh
from tpu_rt.scene import Camera, Scene, procedural
from tpu_rt.trace import device_bvh, trace_wavefront


@pytest.fixture(scope="module")
def setup():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    scene = Scene(procedural.make_blob(500, seed=50))
    flat = device_bvh(flatten_bvh(build_sbvh(scene), scene.tri_vtx_index, scene.vtx_pos))
    rng = np.random.default_rng(0)
    lo, hi = scene.bbox()
    size = float(np.linalg.norm(hi - lo))
    n = 2048
    origin = ((lo + hi) / 2 + rng.normal(size=(n, 3)) * size).astype(np.float32)
    target = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = target - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = make_rays(origin, d, np.zeros(n), np.full(n, 4 * size))
    return scene, flat, rays


def test_trace_sharded_matches_single(setup):
    scene, flat, rays = setup
    mesh = make_ray_mesh()
    single = trace_wavefront(flat, rays)
    sharded = trace_sharded(replicate_bvh(flat, mesh), shard_rays(rays, mesh), mesh)
    np.testing.assert_array_equal(np.asarray(sharded.tri), np.asarray(single.tri))
    np.testing.assert_allclose(np.asarray(sharded.t), np.asarray(single.t), rtol=1e-6)


def test_pad_rays_for_mesh(setup):
    scene, flat, rays = setup
    mesh = make_ray_mesh()
    odd = jax.tree_util.tree_map(lambda x: x[:1001], rays)
    padded, n = pad_rays(odd, mesh.devices.size)
    assert n == 1001 and padded.origin.shape[0] % 8 == 0
    hits = trace_sharded(replicate_bvh(flat, mesh), shard_rays(padded, mesh), mesh)
    single = trace_wavefront(flat, odd)
    np.testing.assert_array_equal(np.asarray(hits.tri)[:1001], np.asarray(single.tri))
    # Padding rays are degenerate -> always miss.
    assert np.all(np.asarray(hits.tri)[1001:] == -1)


def test_render_diff_sharded_matches_single(setup):
    scene, flat, rays = setup
    mesh = make_ray_mesh()
    vtx = jnp.asarray(scene.vtx_pos)
    tvi = jnp.asarray(scene.tri_vtx_index)
    mat = jnp.asarray(scene.tri_material)
    single = render_image_diff(flat, rays, vtx, tvi, mat)
    sharded = render_diff_sharded(
        mesh, replicate_bvh(flat, mesh), shard_rays(rays, mesh), vtx, tvi, mat
    )
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single), rtol=1e-6, atol=1e-7)


def test_grad_step_sharded_matches_single(setup):
    scene, flat, rays = setup
    mesh = make_ray_mesh()
    vtx = jnp.asarray(scene.vtx_pos)
    tvi = jnp.asarray(scene.tri_vtx_index)
    mat = jnp.asarray(scene.tri_material)
    rng = np.random.default_rng(1)
    target = jnp.asarray(rng.uniform(0, 1, (rays.origin.shape[0], 3)).astype(np.float32))

    loss_sh, g_vtx_sh, g_mat_sh = grad_step_sharded(
        mesh, replicate_bvh(flat, mesh), shard_rays(rays, mesh), vtx, tvi, mat,
        jax.device_put(target, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("rays", None))),
    )

    def single_loss(vp, m):
        rgb = render_image_diff(flat, rays, vp, tvi, m)
        return jnp.mean((rgb - target) ** 2)

    loss_1, (g_vtx_1, g_mat_1) = jax.value_and_grad(single_loss, argnums=(0, 1))(vtx, mat)
    np.testing.assert_allclose(float(loss_sh), float(loss_1), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g_vtx_sh), np.asarray(g_vtx_1), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(np.asarray(g_mat_sh), np.asarray(g_mat_1), rtol=1e-4, atol=1e-7)


def _replicated(tables, mesh):
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec())), tables)


def test_trace_sharded_routing_tracer(setup):
    """The routing callable from make_routing_tracer (the XLA tracer on
    the CPU) runs inside shard_map and matches the single-device trace."""
    from tpu_rt.trace import make_routing_tracer

    scene, flat, rays = setup
    mesh = make_ray_mesh()
    routing, kind, tables = make_routing_tracer(flat)
    assert kind == "xla"
    rep_tables = _replicated(tables, mesh)
    sharded = trace_sharded(flat, shard_rays(rays, mesh), mesh,
                            routing=routing, tables=rep_tables)
    single = trace_wavefront(flat, rays)
    np.testing.assert_array_equal(np.asarray(sharded.tri), np.asarray(single.tri))
    np.testing.assert_array_equal(np.asarray(sharded.t), np.asarray(single.t))


def test_grad_step_sharded_routing_matches(setup):
    """grad_step_sharded with explicit routing == the default routing:
    routing is discrete, so gradients must be identical."""
    from tpu_rt.trace import make_routing_tracer

    scene, flat, rays = setup
    mesh = make_ray_mesh()
    vtx = jnp.asarray(scene.vtx_pos)
    tvi = jnp.asarray(scene.tri_vtx_index)
    mat = jnp.asarray(scene.tri_material)
    rng = np.random.default_rng(2)
    target = jax.device_put(
        jnp.asarray(rng.uniform(0, 1, (rays.origin.shape[0], 3)).astype(np.float32)),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("rays", None)),
    )
    rep = replicate_bvh(flat, mesh)
    srays = shard_rays(rays, mesh)

    base = grad_step_sharded(mesh, rep, srays, vtx, tvi, mat, target)
    routing, _, tables = make_routing_tracer(flat)
    routed = grad_step_sharded(mesh, rep, srays, vtx, tvi, mat, target,
                               routing=routing, tables=_replicated(tables, mesh))
    for a, b in zip(base, routed):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-8)


def test_routing_recreated_does_not_recompile(setup):
    """The routing callable is a static jit argument: creating it again
    for the same scene must hit the compiled sharded trace."""
    from tpu_rt.dist.sharding import _trace_sharded_jit
    from tpu_rt.trace import make_routing_tracer

    scene, flat, rays = setup
    mesh = make_ray_mesh()
    srays = shard_rays(rays, mesh)
    routing, _, tables = make_routing_tracer(flat)
    trace_sharded(flat, srays, mesh, routing=routing, tables=_replicated(tables, mesh))
    before = _trace_sharded_jit._cache_size()
    routing2, _, tables2 = make_routing_tracer(flat)
    assert routing2 == routing and hash(routing2) == hash(routing)
    trace_sharded(flat, srays, mesh, routing=routing2, tables=_replicated(tables2, mesh))
    assert _trace_sharded_jit._cache_size() == before


def test_measure_scaling(setup):
    """Scaling-efficiency harness runs on the 8-device CPU mesh and
    reports a sane efficiency (timing quality is not asserted on CPU)."""
    from tpu_rt.dist import init_multihost, measure_scaling

    assert init_multihost() == 1  # single-process no-op path
    scene, flat, rays = setup
    out = measure_scaling(flat, rays, repeats=1, warmup=1)
    assert out["n_devices"] == 8
    assert out["rate_1_rays_per_s"] > 0 and out["rate_n_rays_per_s"] > 0
    assert np.isfinite(out["efficiency"]) and out["efficiency"] > 0


def test_scaling_smoke(setup):
    # All 8 devices hold a shard of the rays; BVH replicated on each.
    scene, flat, rays = setup
    mesh = make_ray_mesh()
    sharded_rays = shard_rays(rays, mesh)
    assert len(sharded_rays.origin.sharding.device_set) == 8
    rep = replicate_bvh(flat, mesh)
    assert len(rep.nodes.sharding.device_set) == 8


def test_two_process_multihost():
    """SURVEY section 4 multi-host-on-CPU: spawn 2 REAL processes that
    join via jax.distributed.initialize (coordinator on localhost),
    build a mesh spanning both processes' devices, and trace a batch
    sharded across them; process 0 asserts the result equals its
    single-device trace (tests/_multihost_worker.py)."""
    import socket
    import subprocess
    import sys as _sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "_multihost_worker.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen(
        [_sys.executable, worker, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=root) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    if any(p.returncode != 0 for p in procs):
        joined = "\n----\n".join(outs)
        if "distributed" in joined and ("unimplemented" in joined.lower()
                                        or "unavailable" in joined.lower()):
            pytest.skip("jax.distributed unsupported on this platform:\n"
                        + joined[-500:])
        pytest.fail("multihost worker failed:\n" + joined)
    assert "MULTIHOST_OK procs=2 devices=4" in outs[0], outs[0]


def test_collective_audit_zero_forward(setup):
    """Mechanical zero-collective proof: the forward
    sharded trace lowers and compiles with NO collective ops, and the
    grad step contains exactly the 3 expected psums (loss + vertex +
    material gradient all-reduces; the psum(1) device count constant-
    folds at trace time) — nothing else."""
    from tpu_rt.dist import collective_audit

    scene, flat, rays = setup
    mesh = make_ray_mesh()
    vtx = jnp.asarray(scene.vtx_pos)
    tvi = jnp.asarray(scene.tri_vtx_index)
    mat = jnp.asarray(scene.tri_material)
    rng = np.random.default_rng(3)
    target = jax.device_put(
        jnp.asarray(rng.uniform(0, 1, (rays.origin.shape[0], 3)).astype(np.float32)),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("rays", None)),
    )
    audit = collective_audit(mesh, replicate_bvh(flat, mesh),
                             shard_rays(rays, mesh), vtx, tvi, mat, target)
    assert audit["forward_stablehlo"] == {}, audit
    assert audit["forward_compiled"] == {}, audit
    assert audit["grad_step_stablehlo"] == {"all_reduce": 3}, audit
    compiled = audit["grad_step_compiled"]
    assert set(compiled) == {"all-reduce"}, audit
    assert 1 <= compiled["all-reduce"] <= 3, audit  # XLA may combine


def test_collective_audit_routing_tracer(setup):
    """Same audit with the routing callable from make_routing_tracer: the
    tracer runs per device inside shard_map, so the collective story
    must be identical."""
    from tpu_rt.dist import collective_audit
    from tpu_rt.trace import make_routing_tracer

    scene, flat, rays = setup
    mesh = make_ray_mesh()
    routing, kind, tables = make_routing_tracer(flat)
    vtx = jnp.asarray(scene.vtx_pos)
    tvi = jnp.asarray(scene.tri_vtx_index)
    mat = jnp.asarray(scene.tri_material)
    rng = np.random.default_rng(4)
    target = jax.device_put(
        jnp.asarray(rng.uniform(0, 1, (rays.origin.shape[0], 3)).astype(np.float32)),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("rays", None)),
    )
    audit = collective_audit(mesh, replicate_bvh(flat, mesh),
                             shard_rays(rays, mesh), vtx, tvi, mat, target,
                             routing=routing, tables=_replicated(tables, mesh))
    assert audit["forward_stablehlo"] == {}, audit
    assert audit["forward_compiled"] == {}, audit
    assert audit["grad_step_stablehlo"] == {"all_reduce": 3}, audit
    assert set(audit["grad_step_compiled"]) == {"all-reduce"}, audit
