"""The port's mesh across processes (parallel/mesh.py init_distributed,
global_arrays; the rank-aware collectives of parallel/collectives.py)
against the JAX package's single device -- the counterpart of
tests/test_dcn_distributed.py.

Two worker processes join a ``torch.distributed`` group over gloo on the
CPU (a free port on localhost), each holding 4 CPU positions:

- ``1d``: the node mesh of 8 shards, ranks 0 and 1 holding shards 0-3 and
  4-7: every collective of every route (the per-pod scan's pmax / pmin /
  psum a pod, the rounds scan's top-k merge and owner gathers a round, the
  chunked route's stitch and usage gathers) exchanges across the ranks;
- ``2x4``: the pods x nodes grid, rank r holding pod row r with its 4 node
  shards: the entry gather of the pod rows is the cross-rank exchange.

In each, both ranks run spread_affinity(8, 16, seed=3) through
sharded_schedule_batch (test_dcn_distributed.py's step), the routed step on
it (the rounds route), and the routed step on heterogeneous(10, 128,
seed=3) dense (the chunked route) and on HoistCache(mesh=)'s class state
(the class waves), and check pmax / pmin / psum and the tiled gather of
bool and bf16 blocks in global shard order.  The parent holds every rank's
choices and usage to the JAX package's single-device schedule_batch (the
workers import only the port), and ordinals and sweeps to the port's
single-device route.  Each test has a timeout of 120 s.

Tolerance: none (bit-identical).
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config
from kubernetes_tpu_torch.ops.assign import dispatch, finish
from kubernetes_tpu_torch.ops.incremental import HoistCache
from kubernetes_tpu_torch.parallel import mesh as tm
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 110
# tag -> (workload, args, routed, class state)
RUNS = {"batch": ("spread_affinity", (8, 16), False, False), "rounds": ("spread_affinity", (8, 16), True, False),
        "chunked": ("heterogeneous", (10, 128), True, False), "waves": ("heterogeneous", (10, 128), True, True)}

WORKER = textwrap.dedent(
    """
    import sys
    rank, port, shape, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config
    from kubernetes_tpu_torch.ops.incremental import HoistCache
    from kubernetes_tpu_torch.parallel import collectives
    from kubernetes_tpu_torch.parallel.mesh import GridMesh, NodeMesh, global_arrays, init_distributed
    from kubernetes_tpu_torch.parallel.sharded import sharded_schedule_batch, sharded_schedule_batch_routed
    mesh_shape = tuple(int(v) for v in shape.split("x")) if "x" in shape else None
    mesh = init_distributed(f"127.0.0.1:{{port}}", 2, rank, mesh_shape=mesh_shape, devices=["cpu"] * 4)
    span = mesh.span
    assert span.backend == "gloo" and dist.get_world_size() == 2 and dist.get_rank() == rank
    if mesh_shape is None:
        assert isinstance(mesh, NodeMesh) and mesh.size == 8 and list(mesh.ids) == list(range(4 * rank, 4 * rank + 4))
    else:
        assert isinstance(mesh, GridMesh) and mesh.shape == mesh_shape and list(mesh.row_ids) == [rank]
    # the collectives across the ranks, in global shard order
    ids = collectives.shard_ids(4, span)
    parts = [torch.tensor([float(j), -float(j), 0.1 * j]) for j in ids]
    sums = torch.tensor(0.0)
    for j in range(8):
        sums = sums + torch.tensor(0.1 * j)
    for got in collectives.pmax(parts, span):
        assert got[:2].tolist() == [7.0, 0.0], got
    for got in collectives.pmin(parts, span):
        assert got[:2].tolist() == [0.0, -7.0], got
    for got in collectives.psum(parts, span):
        assert torch.equal(got[2], sums), got
    bits = [torch.arange(3 * 2).reshape(3, 2) % (j + 2) == 0 for j in ids]
    whole = collectives.all_gather_nodes(bits, 1, "cpu", span)
    assert whole.shape == (3, 16) and torch.equal(whole, torch.cat([torch.arange(6).reshape(3, 2) % (j + 2) == 0
                                                                    for j in range(8)], 1))
    bf = collectives.all_gather_nodes([torch.full((2,), float(j), dtype=torch.bfloat16) for j in ids], 0, "cpu", span)
    assert bf.dtype == torch.bfloat16 and bf.tolist() == [float(j) for j in range(8) for _ in range(2)]
    res = {{}}
    for tag, (gen, args, routed, with_inc) in {runs!r}.items():
        snap = getattr(workloads, gen)(*args, seed=3)
        arr, meta = encode_snapshot(snap, device="cpu")
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        garr = global_arrays(mesh, arr)
        assign.reset_trace_counts()
        if routed:
            inc = HoistCache(mesh=mesh).ensure(garr, meta, cfg) if with_inc else None
            assert not with_inc or inc is not None
            c, u, o, sw = sharded_schedule_batch_routed(garr, cfg, mesh, device="cpu", with_ordinals=True, inc=inc)
            res[tag + "/ordinals"] = o[:meta.n_pods].numpy()
            res[tag + "/sweeps"] = np.asarray(sw)
        else:
            c, u = sharded_schedule_batch(garr, cfg, mesh, device="cpu")
        res[tag + "/choices"] = c[:meta.n_pods].numpy()
        res[tag + "/used"] = u[:arr.N].numpy()
        res[tag + "/pad_used"] = u[arr.N:].numpy()
        res[tag + "/routes"] = np.asarray(sorted(k for k, v in assign.TRACE_COUNTS.items() if v))
    res["exchanges"] = np.asarray(span.stats["calls"])
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
    print(f"RANK{{rank}} OK", flush=True)
    """
).format(repo=REPO, runs=RUNS)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _want():
    """Per run: the JAX package's single-device choices and usage, and the
    port's single-device ordinals and sweeps of the same route."""
    from kubernetes_tpu import ops as jops
    from kubernetes_tpu.api.snapshot import encode_snapshot as jencode
    from kubernetes_tpu.bench import workloads as jw

    out = {}
    for tag, (gen, args, routed, with_inc) in RUNS.items():
        ja, _ = jencode(getattr(jw, gen)(*args, seed=3))
        jcfg = jops.infer_score_config(ja, jops.DEFAULT_SCORE_CONFIG)
        choices, used = jops.schedule_batch(ja, jcfg)
        arr, meta = encode_snapshot(getattr(tw, gen)(*args, seed=3), device="cpu")
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        inc = HoistCache().ensure(arr, meta, cfg) if with_inc else None
        step = finish(dispatch(arr, cfg, "cpu", inc=inc, chunked=True))
        out[tag] = dict(choices=np.asarray(choices)[:meta.n_pods], used=np.asarray(used),
                        ordinals=step.ordinals[:meta.n_pods].numpy(), sweeps=step.sweeps)
    return out


@pytest.mark.parametrize("shape", ["1d", "2x4"])
def test_two_process_mesh_matches_jax_single_device(shape, tmp_path):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(rank), str(port), shape,
                               str(tmp_path / f"r{rank}.npz")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
             for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"distributed workers did not finish within {TIMEOUT_S} s")
    joined = "\n---\n".join(outs)
    assert all(p.returncode == 0 for p in procs), joined[-4000:]
    assert "RANK0 OK" in joined and "RANK1 OK" in joined, joined[-2000:]
    want = _want()
    ranks = [np.load(tmp_path / f"r{rank}.npz") for rank in (0, 1)]
    for tag, (_, _, routed, with_inc) in RUNS.items():
        w = want[tag]
        for got in ranks:
            np.testing.assert_array_equal(got[tag + "/choices"], w["choices"], err_msg=tag)
            np.testing.assert_array_equal(got[tag + "/used"], w["used"], err_msg=tag)
            assert not got[tag + "/pad_used"].any(), tag
            if routed:
                np.testing.assert_array_equal(got[tag + "/ordinals"], w["ordinals"], err_msg=tag)
                assert int(got[tag + "/sweeps"]) == w["sweeps"], tag
        routes = set(ranks[0][tag + "/routes"].tolist())
        want_route = {"batch": "sharded_plain", "rounds": "sharded_rounds", "chunked": "sharded_chunked",
                      "waves": "sharded_chunked_inc"}[tag]
        assert want_route in routes, (tag, routes)
    # the 1-D mesh exchanges at every per-step collective; the grid at its entry gathers
    calls = [int(r["exchanges"]) for r in ranks]
    assert calls[0] == calls[1] and calls[0] > (100 if shape == "1d" else 4), calls


def test_init_distributed_refusals():
    """Shapes that do not fit the ranks, a pod row split across ranks, and
    ranks sharing a card without an explicit backend are refused before any
    process group is joined."""
    with pytest.raises(ValueError, match="positions"):
        tm.init_distributed("127.0.0.1:1", 2, 0, mesh_shape=(2, 3), devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="whole rows"):
        tm.init_distributed("127.0.0.1:1", 4, 0, mesh_shape=(2, 4), devices=["cpu"] * 2)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="backend='gloo'"):
            tm.init_distributed("127.0.0.1:1", 2, 0, devices=["cuda:0"])
