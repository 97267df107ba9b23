"""The port's multi-rank bring-up and sharded pose graph on the CPU: four
gloo ranks (``icp_variants_tpu_torch/scripts/multihost_rehearsal.py``,
rendezvous through a file under the test's temporary directory) against
the JAX package's ``refine_sharded`` on a 4-device mesh; ``distributed``'s
initialization with and without a launcher's environment; the two port
scripts at one and two processes, as tests/test_multihost.py runs JAX's.

Tolerances: tests/test_pose_graph.py's own (the dense loop within rtol
1e-4 / atol 1e-5 of the single-device solve, the 120-pose CG chain within
rtol 1e-3 / atol 2e-4); the ranks' refined poses equal bit for bit.
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

from icp_variants_tpu.parallel import pose_graph as jpg
from icp_variants_tpu.workloads import eth as jeth
from icp_variants_tpu_torch.parallel import distributed as tdist
from icp_variants_tpu_torch.parallel import pose_graph as tpg
from icp_variants_tpu_torch.scripts import multihost_rehearsal as rehearsal
from icp_variants_tpu_torch.workloads import eth as teth
from test_pose_graph import make_chain_with_closures, make_loop_problem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
RANKS_TIMEOUT_S = 240


def _loop_graph():
    """tests/test_pose_graph.py's 10-pose loop: the chain and its closure
    (weight 5, as its single-device test gives it)."""
    _, pair, loop_rel = make_loop_problem(v=10)
    odo, graph = jpg.sequential_graph(pair)
    v = len(odo)
    return odo, jpg.PoseGraph(
        edge_i=jnp.concatenate([graph.edge_i, jnp.asarray([v - 1], jnp.int32)]),
        edge_j=jnp.concatenate([graph.edge_j, jnp.asarray([0], jnp.int32)]),
        rel_poses=jnp.concatenate([graph.rel_poses, jnp.asarray(loop_rel)[None]]),
        weights=jnp.concatenate([graph.weights, jnp.asarray([5.0], jnp.float32)]))


GRAPHS = {
    # name: (base poses and graph, GN iterations, rtol, atol)
    "dense": (_loop_graph, 6, 1e-4, 1e-5),
    "cg": (lambda: make_chain_with_closures(v=120, seed=6)[1:], 4, 1e-3, 2e-4),
}


def _graph_arrays(odo, graph):
    return dict(base_poses=np.asarray(odo, np.float32),
                edge_i=np.asarray(graph.edge_i, np.int64), edge_j=np.asarray(graph.edge_j, np.int64),
                rel_poses=np.asarray(graph.rel_poses, np.float32),
                weights=np.asarray(graph.weights, np.float32))


def _chain():
    """A 12-scan chain of relative poses for ``refine_trajectory``."""
    _, pair, _ = make_loop_problem(v=13, seed=2)
    return pair.astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Four ranks (mesh 4 x 1) refining every graph of GRAPHS and the
    chain; returns the case directory once they have all exited."""
    root = tmp_path_factory.mktemp("multihost")
    cases = []
    for name, (make, iters, _, _) in GRAPHS.items():
        np.savez(root / f"{name}.npz", **_graph_arrays(*make()))
        cases.append(dict(name=name, kind="refine", points_per_pair=1, data=f"{name}.npz",
                          n_iterations=iters))
    np.savez(root / "chain.npz", rel_poses=_chain())
    cases.append(dict(name="trajectory", kind="trajectory", points_per_pair=1, data="chain.npz"))
    rehearsal.write_spec(root, cases)
    procs = rehearsal.start_ranks(WORLD, f"file://{root}/rdzv", root, cases=root, device="cpu")
    outs = rehearsal.join_ranks(procs, root, RANKS_TIMEOUT_S)
    assert all("CASES OK" in out for out in outs), outs
    return root


def _rank_poses(root, name):
    poses = [np.load(root / "out" / f"{name}.rank{r}.npz")["pose"] for r in range(WORLD)]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(poses[r], poses[0], err_msg=f"rank {r}")
    return poses[0]


@pytest.mark.parametrize("name", list(GRAPHS))
def test_refine_sharded_matches_jax(ranks, name):
    make, iters, rtol, atol = GRAPHS[name]
    odo, graph = make()
    mesh = jax.make_mesh((WORLD,), ("pairs",), devices=jax.devices()[:WORLD])
    jax_single = np.asarray(jpg.refine(odo, graph, n_iterations=iters))
    jax_sharded = np.asarray(jpg.refine_sharded(odo, graph, mesh, n_iterations=iters))
    port = _rank_poses(ranks, name)
    assert port.shape == (len(odo), 4, 4)
    np.testing.assert_allclose(port, jax_sharded, rtol=rtol, atol=atol)
    np.testing.assert_allclose(port, jax_single, rtol=rtol, atol=atol)
    # The port's own single-device solve, on the same graph.
    a = _graph_arrays(odo, graph)
    single = tpg.refine(a["base_poses"],
                        tpg.PoseGraph(*(torch.from_numpy(a[f]) for f in tpg.PoseGraph._fields)),
                        n_iterations=iters).numpy()
    np.testing.assert_allclose(port, single, rtol=rtol, atol=atol)


def _run_result(rel):
    run = teth.ETHRunResult()
    for k, r in enumerate(rel):
        run.add(teth.ETHPairResult(index=k, initial_error=0.0, final_error=0.0, initial_rmse=0.0,
                                   final_rmse=0.0, rmse_per_iteration=np.zeros(0),
                                   benchmark_per_iteration=np.zeros(0), pose=r))
    return run


def test_refine_trajectory_with_mesh_matches_jax(ranks):
    """``refine_trajectory(mesh=)``: on the four ranks and on a 1 x 1 mesh
    (no process group: exactly the single-device refine) against the JAX
    package's sharded refine over four devices."""
    rel = _chain()
    jmesh = jax.make_mesh((WORLD,), ("pairs",), devices=jax.devices()[:WORLD])
    od_j, ref_j, _ = jeth.refine_trajectory(_run_result(rel), mesh=jmesh)
    port = _rank_poses(ranks, "trajectory")
    np.testing.assert_allclose(port, ref_j, rtol=1e-4, atol=1e-5)
    mesh = tdist.global_mesh(device="cpu")
    od_1, ref_1, _ = teth.refine_trajectory(_run_result(rel), mesh=mesh)
    od_0, ref_0, _ = teth.refine_trajectory(_run_result(rel), device="cpu")
    np.testing.assert_array_equal(ref_1, ref_0)
    np.testing.assert_allclose(od_1, od_j, atol=1e-6)
    np.testing.assert_allclose(ref_1, ref_j, rtol=1e-4, atol=1e-5)


_INIT_CODE = (
    "import json, torch.distributed as dist\n"
    "from icp_variants_tpu_torch.parallel import distributed as d\n"
    "up = d.initialize(device='cpu')\n"
    "m = d.global_mesh(device='cpu')\n"
    "print(json.dumps(dict(up=up, count=d.process_count(), coord=d.is_coordinator(),\n"
    "    shape=m.shape, grouped=m.group('points') is not None, backend=dist.get_backend()\n"
    "    if dist.is_initialized() else None)))\n"
    "if dist.is_initialized():\n"
    "    dist.destroy_process_group()\n"
)


@pytest.mark.parametrize("launcher", [True, False])
def test_initialize_from_launcher_environment(launcher):
    """With ``torchrun``'s variables (a world of one, its store on a port
    the OS picks) ``initialize()`` brings up gloo on the CPU and the mesh
    has real groups; without them it keeps single-process mode, a 1 x 1
    mesh without groups."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    if launcher:
        env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT="0")
    out = subprocess.run([sys.executable, "-c", _INIT_CODE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep == dict(up=launcher, count=1, coord=True, shape={"pairs": 1, "points": 1},
                       grouped=launcher, backend="gloo" if launcher else None)


def test_single_process_mode_and_mesh_divisibility():
    assert not tdist.initialize(device="cpu") or pytest.skip("a process group is up")
    assert tdist.process_count() == 1 and tdist.is_coordinator()
    mesh = tdist.global_mesh(device="cpu")
    assert mesh.shape == {"pairs": 1, "points": 1} and mesh.group("pairs") is None
    with pytest.raises(ValueError, match="1 ranks do not divide into points_per_pair=2"):
        tdist.global_mesh(points_per_pair=2, device="cpu")
    x = torch.arange(3)
    assert tdist.psum(x, None) is x


@pytest.mark.parametrize("world", [1, 2])
def test_rehearsal_script(tmp_path, world):
    """The port's multihost_rehearsal at one and two ranks: bring-up, the
    global mesh (1 x 2 at two ranks), one sharded step."""
    procs = rehearsal.start_ranks(world, f"file://{tmp_path}/rdzv", tmp_path, device="cpu")
    outs = rehearsal.join_ranks(procs, tmp_path, RANKS_TIMEOUT_S)
    for rank, out in enumerate(outs):
        assert f"REHEARSAL OK rank={rank}/{world}" in out, out
    if world == 2:
        assert "'points': 2" in outs[0]


@pytest.mark.parametrize("world", [1, 2])
def test_pod_scaling_bench(tmp_path, world):
    """The port's pod_scaling_bench with --toy at one rank (--single) and
    two: the coordinator's JSON line carries the JAX harness's fields."""
    base = [sys.executable, "-m", "icp_variants_tpu_torch.scripts.pod_scaling_bench", "--toy",
            "--device", "cpu", "--pairs-per-host", "4", "--runs", "1"]
    if world == 1:
        cmds = [base + ["--single"]]
    else:
        cmds = [base + ["--init", f"file://{tmp_path}/rdzv", "--nprocs", "2", "--proc-id", str(r)]
                for r in range(2)]
    logs = [open(tmp_path / f"bench{r}.log", "w") for r in range(len(cmds))]
    procs = [subprocess.Popen(c, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
             for c, log in zip(cmds, logs)]
    try:
        for p in procs:
            p.wait(timeout=RANKS_TIMEOUT_S)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    outs = [(tmp_path / f"bench{r}.log").read_text() for r in range(len(cmds))]
    assert all(p.returncode == 0 for p in procs), outs
    rep = json.loads(outs[0].strip().splitlines()[-1])
    assert rep["world"] == world and rep["pairs"] == 4 * world
    assert rep["pairs_per_sec"] > 0 and rep["pairs_per_sec_per_host"] > 0
    assert rep["pairs_per_sec_per_host"] == pytest.approx(rep["pairs_per_sec"] / world, rel=1e-3)
