"""The port's ring layer (parallel/ring.py) against the JAX package's
parallel/ring.py on the forced 8-device CPU mesh (tests/conftest.py mesh8)
and against the dense numpy reference.

On the CPU:

- ring_match on 8 shards equals the JAX ring_match and the dense count
  rule, on test_ring.py's shapes and seed and on one with E = 3 and the
  constant-false kind; on 2 and 4 shards too;
- ring_match of BASELINE config 3's terms against its pod label rows (the
  matrix the ring exists for; api/pairwise.py match_inputs) equals the JAX
  ring_match and the port's host match matrix;
- the plain hop (match_block_plain) equals the JAX package's _eval_block;
- all_to_all_pods_to_nodes equals the JAX reshard and leaves node-sharded
  blocks [P, N/8];
- the divisibility errors are the JAX package's, message for message.

The ``cuda`` legs import no JAX and skip without a card: kernel K16
ring_match == match_block_plain, written at an offset of a wider output;
ring_match on the card == the dense rule, and at config 3's full width
(80 terms x 10000 pod label rows on 4 shards) == the host match matrix:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ring.py

Tolerance: none.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.parallel import all_to_all_pods_to_nodes, make_mesh, ring_match
from kubernetes_tpu_torch.parallel.ring import match_block_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# (seed, S, E, L, P, kinds): test_ring.py's case, then E = 3 with kind 3
# (KIND_FALSE) among the kinds
CASES = {"test_ring": (3, 16, 2, 24, 64, 3), "e3": (11, 24, 3, 40, 96, 4)}


def _inputs(seed, S, E, L, P, kinds):
    rng = np.random.default_rng(seed)
    sel_mask = (rng.random((S, E, L)) < 0.15).astype(np.float32)
    sel_kind = rng.integers(0, kinds, size=(S, E)).astype(np.int32)
    labels = (rng.random((P, L)) < 0.3).astype(np.float32)
    return sel_mask, sel_kind, labels


def _dense(sel_mask, sel_kind, labels):
    counts = np.einsum("sel,pl->sep", sel_mask, labels)
    kind = sel_kind[:, :, None]
    return np.where(kind == 1, counts > 0, np.where(kind == 2, counts == 0, kind == 0)).all(1)


def _port(x):
    return torch.from_numpy(x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_match_equals_jax_and_dense(case, mesh8):
    import jax.numpy as jnp

    from kubernetes_tpu.parallel.ring import ring_match as jax_ring_match

    sel_mask, sel_kind, labels = _inputs(*CASES[case])
    tiles = ring_match(_port(sel_mask), _port(sel_kind), _port(labels), make_mesh(8, devices="cpu"))
    assert len(tiles) == 8 and {tuple(t.shape) for t in tiles} == {(sel_mask.shape[0] // 8, labels.shape[0])}
    got = torch.cat(tiles).numpy()
    want = np.asarray(jax_ring_match(jnp.array(sel_mask), jnp.array(sel_kind), jnp.array(labels), mesh8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _dense(sel_mask, sel_kind, labels))


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_match_other_mesh_sizes(case, d):
    sel_mask, sel_kind, labels = _inputs(*CASES[case])
    got = torch.cat(ring_match(_port(sel_mask), _port(sel_kind), _port(labels), make_mesh(d, devices="cpu")))
    np.testing.assert_array_equal(got.numpy(), _dense(sel_mask, sel_kind, labels))


@pytest.mark.parametrize("case", sorted(CASES))
def test_match_block_plain_equals_eval_block(case):
    import jax.numpy as jnp

    from kubernetes_tpu.parallel.ring import _eval_block

    sel_mask, sel_kind, labels = _inputs(*CASES[case])
    got = match_block_plain(_port(sel_mask), _port(sel_kind), _port(labels[:13])).numpy()
    np.testing.assert_array_equal(got, np.asarray(_eval_block(jnp.array(sel_mask), jnp.array(sel_kind),
                                                              jnp.array(labels[:13]))))


# (seed, S, E, L, B): label vocabularies of a thousand and more, kinds 0-3
WIDE = {"l1000": (21, 6, 3, 1000, 40), "l1337": (22, 4, 2, 1337, 33), "l5000": (23, 3, 4, 5000, 20)}


def _wide_inputs(seed, S, E, L, B):
    """Masks from a few literals to dense ones, label rows from empty to
    dense, every kind 0-3 (3: KIND_FALSE)."""
    rng = np.random.default_rng(seed)
    dens = rng.choice([0.0005, 0.003, 0.05, 0.5], size=(S, E, 1))
    sel_mask = (rng.random((S, E, L)) < dens).astype(np.float32)
    sel_kind = rng.choice(4, size=(S, E), p=[0.3, 0.3, 0.3, 0.1]).astype(np.int32)
    labels = (rng.random((B, L)) < rng.choice([0.0, 0.01, 0.2], size=(B, 1))).astype(np.float32)
    return sel_mask, sel_kind, labels


@pytest.mark.parametrize("case", sorted(WIDE))
def test_match_block_plain_equals_eval_block_wide(case):
    """The plain hop == the JAX _eval_block at L >= 1000, exactly, and the
    cases are not degenerate (some tiles true, some false)."""
    import jax.numpy as jnp

    from kubernetes_tpu.parallel.ring import _eval_block

    sel_mask, sel_kind, labels = _wide_inputs(*WIDE[case])
    got = match_block_plain(_port(sel_mask), _port(sel_kind), _port(labels)).numpy()
    want = np.asarray(_eval_block(jnp.array(sel_mask), jnp.array(sel_kind), jnp.array(labels)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _dense(sel_mask, sel_kind, labels))
    assert 0 < got.sum() < got.size


def _pod_label_inputs(n_nodes, n_pods):
    """BASELINE config 3's selector x pod-label match (spread_affinity): the
    batch's distinct pairwise terms against its pods' label rows, as
    api/pairwise.py match_inputs lowers them, with _match_matrix's answer."""
    from kubernetes_tpu_torch.api.delta import _pod_pairwise_terms
    from kubernetes_tpu_torch.api.pairwise import _match_matrix, match_inputs
    from kubernetes_tpu_torch.bench import workloads

    pods = workloads.spread_affinity(n_nodes, n_pods, seed=0).pending_pods
    terms = {}
    for pod in pods:
        aff, anti, pref, spread = _pod_pairwise_terms(pod)
        for k in (*aff, *anti, *(x[0] for x in pref), *(x[0] for x in spread)):
            terms.setdefault(k, None)
    terms = list(terms)
    return (*match_inputs(terms, pods), _match_matrix(terms, pods))


def test_ring_match_on_pod_label_rows_matches_jax(mesh8):
    """The matrix the ring exists for: config 3's terms (8 at 1000 pods) x
    its pod label rows, on 8 shards == the JAX ring_match == the port's
    host match matrix (api/pairwise.py _match_matrix)."""
    import jax.numpy as jnp

    from kubernetes_tpu.parallel.ring import ring_match as jax_ring_match

    sel_mask, sel_kind, labels, dense = _pod_label_inputs(200, 1000)
    assert sel_mask.shape[0] == 8 and sel_mask.shape[1] == 2 and labels.shape == (1000, sel_mask.shape[2])
    got = torch.cat(ring_match(_port(sel_mask), _port(sel_kind), _port(labels), make_mesh(8, devices="cpu")))
    np.testing.assert_array_equal(got.numpy(), dense.astype(bool))
    want = np.asarray(jax_ring_match(jnp.array(sel_mask), jnp.array(sel_kind), jnp.array(labels), mesh8))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < dense.sum() < dense.size


def test_all_to_all_reshard_matches_jax(mesh8):
    import jax.numpy as jnp

    from kubernetes_tpu.parallel.ring import all_to_all_pods_to_nodes as jax_a2a

    x = np.random.default_rng(4).standard_normal((32, 16)).astype(np.float32)
    blocks = all_to_all_pods_to_nodes(_port(x), make_mesh(8, devices="cpu"))
    assert {tuple(b.shape) for b in blocks} == {(32, 2)}  # really node-sharded now
    y = jax_a2a(jnp.array(x), mesh8)
    np.testing.assert_array_equal(torch.cat(blocks, dim=1).numpy(), np.asarray(y))
    np.testing.assert_array_equal(torch.cat(blocks, dim=1).numpy(), x)
    want = {np.asarray(s.data).tobytes() for s in y.addressable_shards}
    assert {b.numpy().tobytes() for b in blocks} == want


def test_divisibility_errors_match_jax(mesh8):
    import jax.numpy as jnp

    from kubernetes_tpu.parallel.ring import all_to_all_pods_to_nodes as jax_a2a
    from kubernetes_tpu.parallel.ring import ring_match as jax_ring_match

    m = make_mesh(8, devices="cpu")
    for S, P in ((12, 64), (16, 60)):
        sel_mask, sel_kind, labels = _inputs(1, S, 2, 8, P, 3)
        with pytest.raises(ValueError) as ours:
            ring_match(_port(sel_mask), _port(sel_kind), _port(labels), m)
        with pytest.raises(ValueError) as theirs:
            jax_ring_match(jnp.array(sel_mask), jnp.array(sel_kind), jnp.array(labels), mesh8)
        assert str(ours.value) == str(theirs.value)
    for shape in ((30, 16), (32, 12)):
        x = np.zeros(shape, np.float32)
        with pytest.raises(ValueError) as ours:
            all_to_all_pods_to_nodes(_port(x), m)
        with pytest.raises(ValueError) as theirs:
            jax_a2a(jnp.array(x), mesh8)
        assert str(ours.value) == str(theirs.value)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_ring.py")
    from kubernetes_tpu_torch.ops import kernels

    kernels.build(["ring_match"])
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_match_kernel(card, case):
    from kubernetes_tpu_torch.ops import kernels

    sel_mask, sel_kind, labels = (_port(a).to(card) for a in _inputs(*CASES[case]))
    want = match_block_plain(sel_mask, sel_kind, labels)
    assert torch.equal(kernels.ring_match(sel_mask, sel_kind, labels), want)
    wide = torch.zeros((sel_mask.shape[0], labels.shape[0] + 40), dtype=torch.bool, device=card)
    kernels.ring_match(sel_mask, sel_kind, labels, out=wide, col0=17)
    assert torch.equal(wide[:, 17:17 + labels.shape[0]], want)
    assert not wide[:, :17].any() and not wide[:, 17 + labels.shape[0]:].any()
    # a term mask wider than the kernel's 48 KB of shared memory
    big = (torch.rand((4, 3, 5000), generator=torch.Generator().manual_seed(0)) < 0.001).float().to(card)
    lab = (torch.rand((300, 5000), generator=torch.Generator().manual_seed(1)) < 0.3).float().to(card)
    kind = torch.tensor([[1, 2, 0]] * 4, dtype=torch.int32, device=card)
    assert torch.equal(kernels.ring_match(big, kind, lab), match_block_plain(big, kind, lab))


# (seed, Sl, E, L, B): the label widths around a word and a wide one (E x L
# above the old kernel's 12 K floats of shared memory), B not a multiple of
# the 32-row tile; 64 x 4 terms' masks past the staged words; a row's words
# too many for 32 rows a block; one term (a block of one warp), at the
# north star's hop and at a ragged width
KERNEL_SHAPES = [(31, 5, 3, 1, 77), (32, 5, 3, 31, 77), (33, 5, 3, 32, 70), (34, 5, 3, 33, 65),
                 (35, 5, 3, 5000, 45), (36, 64, 4, 1100, 40), (37, 2, 2, 60000, 45), (38, 1, 1, 1, 5120),
                 (39, 1, 3, 33, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=lambda x: "x".join(map(str, x[1:])))
def test_ring_match_kernel_shapes(card, shape):
    """K16 == match_block_plain, alone and at col0 = 19 of a wider output
    (nothing else written)."""
    from kubernetes_tpu_torch.ops import kernels

    sel_mask, sel_kind, labels = (_port(a).to(card) for a in _wide_inputs(*shape))
    want = match_block_plain(sel_mask, sel_kind, labels)
    assert torch.equal(kernels.ring_match(sel_mask, sel_kind, labels), want)
    wide = torch.zeros((sel_mask.shape[0], labels.shape[0] + 40), dtype=torch.bool, device=card)
    kernels.reset_launches()
    kernels.ring_match(sel_mask, sel_kind, labels, out=wide, col0=19)
    assert kernels.LAUNCHES["ring_match"] == 1
    assert torch.equal(wide[:, 19:19 + labels.shape[0]], want)
    assert not wide[:, :19].any() and not wide[:, 19 + labels.shape[0]:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4])
def test_ring_on_card(card, d):
    from kubernetes_tpu_torch.ops import kernels

    sel_mask, sel_kind, labels = _inputs(*CASES["e3"])
    kernels.reset_launches()
    tiles = ring_match(_port(sel_mask), _port(sel_kind), _port(labels), make_mesh(d))
    assert kernels.LAUNCHES["ring_match"] == d * d
    np.testing.assert_array_equal(torch.cat(tiles).cpu().numpy(), _dense(sel_mask, sel_kind, labels))
    x = torch.randn((64, 32), generator=torch.Generator().manual_seed(2))
    blocks = all_to_all_pods_to_nodes(x.to(card), make_mesh(d))
    assert torch.equal(torch.cat(blocks, dim=1).cpu(), x)


@pytest.mark.cuda
def test_ring_on_card_at_config3_width(card):
    """Config 3 at full size: its 80 terms x its 10000 pod label rows on 4
    shards == the host match matrix; one hop of K16 == plain."""
    from kubernetes_tpu_torch.ops import kernels

    sel_mask, sel_kind, labels, dense = (_port(a) for a in _pod_label_inputs(5000, 10000))
    assert sel_mask.shape[0] == 80 and labels.shape[0] == 10000
    tiles = ring_match(sel_mask, sel_kind, labels, make_mesh(4))
    assert torch.equal(torch.cat(tiles).cpu(), dense.bool())
    hs, hk, hl = sel_mask[:20].to(card), sel_kind[:20].to(card), labels[:2500].to(card)
    assert torch.equal(kernels.ring_match(hs, hk, hl), match_block_plain(hs, hk, hl))
