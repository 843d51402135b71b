"""Stage B of the class-wave route (kernel K6 chunk_rounds and its plain
version) on the chunk classes its walk distinguishes, for
tests/test_torch_waves.py (the CPU: a numpy emulation of the walk against
ops/assign.py schedule_scan_chunked_plain) and tests/test_torch_kernels.py
(the card: K6 against the plain version).  Imports no JAX.

Cases (build_case):

- ``skip``: heterogeneous(64, 300), the default wave commits every pod: no
  chunk needs rounds (the JAX lax.cond skip);
- ``partial``: basic(48, 1500) with two-entry lists in 64-pod blocks: the
  wave's block budget runs out, so it commits a prefix and stage B walks
  the rest; the last chunks hold the invalid pad pods (P = 2048);
- ``reopened``: the partial wave with REOPEN's pods taken back out of it,
  so chunks that need rounds sit between chunks the wave committed whole
  (a wave commits a prefix, so only such a mask gives a list with gaps;
  stage B's function is defined for any mask);
- ``no-wave``: heterogeneous(64, 300) with the waves off: every chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config
from kubernetes_tpu_torch.ops.incremental import HoistCache

CASES = ("skip", "partial", "reopened", "no-wave")
KNOBS = {"partial": dict(wave_k=2, wave_block=64), "reopened": dict(wave_k=2, wave_block=64)}
# pods the reopened case takes back out of the wave: all of chunk 3, one pod
# of chunk 9, all of chunk 20 (the partial wave commits chunks 0..26 whole)
REOPEN = list(range(96, 128)) + [301] + list(range(640, 672))
TILE = 1024  # chunks a tile of K6's list_chunks (one a thread of its block)


def build_case(name: str, device="cpu"):
    """-> (arr, cfg, inc, used0, t0u0, wave): stage B's inputs, `wave` =
    (committed, out, ordinal, n_blocks) or None, as the route hands them to
    K6 after the plain wave (n_blocks a Python int)."""
    snap = tw.basic(48, 1500) if name in ("partial", "reopened") else tw.heterogeneous(64, 300)
    arr, meta = encode_snapshot(snap, device=device)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    t0u = assign.t0u_prologue(inc, arr.N)
    if name == "no-wave":
        return arr, cfg, inc, arr.node_used, t0u, None
    w = assign.wave_commit_plain(inc.cls, arr.pod_valid, arr.pod_req, arr.node_used, t0u, inc.stat_u,
                                 arr.node_alloc, inc.req_u, cfg, **KNOBS.get(name, {}))
    wcom, wout, wordn = w[0].clone(), w[1].clone(), w[2].clone()
    if name == "reopened":
        idx = torch.tensor(REOPEN, device=arr.device)
        wcom[idx] = False
        wout[idx] = -1
        wordn[idx] = 0
    return arr, cfg, inc, w[3], w[4], (wcom, wout, wordn, w[5])


def open_chunks(P: int, wcom) -> np.ndarray:
    """bool[P / C]: the chunks that need rounds (a pod the wave did not
    commit; every chunk with no wave)."""
    C = assign.INC_CHUNK
    if wcom is None:
        return np.ones(P // C, dtype=bool)
    return ~np.asarray(wcom.cpu()).reshape(P // C, C).all(axis=1)


def list_chunks(open_: np.ndarray) -> np.ndarray:
    """K6's compaction (csrc/chunk_rounds.cu list_chunks) step by step: per
    tile of TILE chunks, warp w's 32-bit mask of its chunks that need
    rounds, the exclusive prefix of the warps' counts, then lane j writes
    chunk 32 w + j at total + prefix[w] + popc(mask below j)."""
    nch = open_.shape[0]
    out = np.full(nch, -1, dtype=np.int64)
    total = 0
    for t0 in range(0, nch, TILE):
        masks = []
        for w in range(TILE // 32):
            m = 0
            for j in range(32):
                ci = t0 + 32 * w + j
                if ci < nch and open_[ci]:
                    m |= 1 << j
            masks.append(m)
        counts = [bin(m).count("1") for m in masks]
        prefix = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for w, m in enumerate(masks):
            for j in range(32):
                if (m >> j) & 1:
                    out[total + prefix[w] + bin(m & ((1 << j) - 1)).count("1")] = t0 + 32 * w + j
        total += sum(counts)
    return out[:total]


def emulate_walk(arr, cfg, inc, used0, t0u0, wave):
    """K6's walk in numpy around the plain chunk step: classify, compact,
    the skip when nothing is listed, else only the listed chunks' rounds in
    list order, `base` counting only their rounds, the wave's decisions and
    ordinals everywhere else -> (choices, used, ordinals, sweeps, list)."""
    P, N = arr.P, arr.N
    C = assign.INC_CHUNK
    K = min(C + 1, N)
    Z = min(assign.SPECZ, K)
    if wave is None:
        wcom, n_blocks = None, 0
        com = np.zeros(P, dtype=bool)
        choices = np.full(P, -1, dtype=np.int32)
        ordinals = np.zeros(P, dtype=np.int32)
    else:
        wcom, wout, wordn, n_blocks = wave
        com = np.asarray(wcom.cpu())
        choices = np.asarray(wout.cpu()).copy()
        ordinals = np.asarray(wordn.cpu()).copy()
    listed = list_chunks(open_chunks(P, wcom))
    np.testing.assert_array_equal(listed, np.flatnonzero(open_chunks(P, wcom)))
    used = used0.clone()
    if listed.size == 0:
        return choices, np.asarray(used.cpu()), ordinals, int(n_blocks), listed
    t0u = t0u0
    cls64 = inc.cls.to(torch.int64)
    dev = arr.device
    base = 0
    for ci in listed:
        sl = slice(int(ci) * C, (int(ci) + 1) * C)
        wc = torch.as_tensor(com[sl], device=dev)
        wo = torch.as_tensor(choices[sl], device=dev)
        out, nr, ord_, used, t0u = assign._chunk_plain(
            cfg, arr.pod_req[sl], cls64[sl], arr.pod_valid[sl], used, t0u, arr.node_alloc, inc.stat_u,
            inc.req_u, wc, wo, C, K, Z)
        choices[sl] = np.asarray(out.cpu())
        ordinals[sl] = np.where(com[sl], ordinals[sl], base + np.asarray(ord_.cpu()) + int(n_blocks))
        base += nr
    return choices, np.asarray(used.cpu()), ordinals, base + int(n_blocks), listed
