"""The packed static planes (kernel K7's function, and K3's over class rows)
on inputs that stress their word layout, against the JAX package's.

Inputs are made from a seed with numpy (tests below): node validity, hard
taints, labels, tolerations, nodeName pins, selector terms.  On the CPU the
port's ``packed_static_rows_plain`` (with and without the eligibility
plane) must equal the JAX package's packed rows -- ``ops/filters.py:92``
``static_feasible_rows`` of the term match, packed by ``ops/bitplane.py``
``pack``, the eligibility plane ``pack(nodesel & node_valid)``
(``ops/assign.py:1669-1678``) -- word for word, on: N not a multiple of 32;
T > 32 (three toleration words); padded selector-term slots (and a pod
with a selector whose slots are all padding); pins, -2 (the named node is
missing) among them, on a node shard whose first global id `base` is not
0; more than 65535 pod rows at a small N; every pod invalid.  Tolerance:
none.

The ``cuda`` legs hold kernel K7 (both planes), its gated mode (``done``
set: nothing written) and kernel K3 (class rows, no pod_valid term) to the
plain version on the same inputs; they import no JAX and skip without a
card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_static_rows.py
"""

import types

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# case -> (P, N, T, TT, S, E, L, base, seed, draw overrides)
CASES = {
    "odd-n": (96, 45, 3, 2, 4, 2, 5, 0, 1, {}),
    "wide-taints": (64, 64, 70, 2, 3, 2, 4, 0, 2, {}),
    "padded-terms": (80, 100, 2, 4, 6, 2, 6, 0, 3, {"term_pad": 0.7}),
    "pins": (128, 70, 2, 2, 3, 1, 4, 37, 4, {"pins": True}),
    "many-rows": (70000, 40, 2, 2, 3, 2, 4, 0, 5, {}),
    "all-invalid": (64, 50, 2, 2, 3, 2, 4, 0, 6, {"valid": 0.0}),
}


def draw(name):
    """The case's input fields as numpy arrays, and its base."""
    P, N, T, TT, S, E, L, base, seed, over = CASES[name]
    rng = np.random.default_rng(seed)
    f = dict(
        node_valid=rng.random(N) < 0.9,
        node_taint_ns=rng.random((N, T)) < 0.15,
        node_labels=rng.random((N, L)) < 0.5,
        pod_valid=rng.random(P) < over.get("valid", 0.85),
        pod_tol_ns=rng.random((P, T)) < 0.7,
        pod_nodename=np.full(P, -1, dtype=np.int32),
        pod_terms=rng.integers(0, S, size=(P, TT)).astype(np.int32),
        pod_has_sel=rng.random(P) < 0.6,
        sel_mask=rng.random((S, E, L)) < 0.4,
        sel_kind=rng.integers(0, 3, size=(S, E)).astype(np.int32),
    )
    pad = over.get("term_pad", 0.2)
    f["pod_terms"][rng.random((P, TT)) < pad] = -1
    f["pod_terms"][0] = -1  # a selector of padding only selects nothing
    f["pod_has_sel"][0] = True
    if over.get("pins"):
        # global ids: inside this shard [base, base + N), before it, past it, and -2
        choices = np.array([-1, -2, base, base + 1, base + N - 1, base - 1, base + N, 5], dtype=np.int32)
        f["pod_nodename"] = choices[rng.integers(0, len(choices), size=P)]
    return f, base


def port_arrays(f, device="cpu"):
    """The fields as the port's arrays (what packed_static_rows reads)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in f.items()}
    return types.SimpleNamespace(P=len(f["pod_valid"]), N=len(f["node_valid"]), device=t["node_valid"].device, **t)


def jax_planes(f, base):
    """The JAX package's packed static and eligibility planes, int32 bit patterns."""
    import jax.numpy as jnp

    from kubernetes_tpu.ops import bitplane, filters

    j = {k: jnp.asarray(v) for k, v in f.items()}
    tm = filters.term_match(j["sel_mask"], j["sel_kind"], j["node_labels"])
    my_nodes = base + jnp.arange(len(f["node_valid"]), dtype=jnp.int32)
    sf, nsb = filters.static_feasible_rows(tm, j["node_valid"], j["node_taint_ns"], my_nodes, j["pod_terms"],
                                           j["pod_has_sel"], j["pod_tol_ns"], j["pod_nodename"], j["pod_valid"])
    return (np.asarray(bitplane.pack(sf)).view(np.int32),
            np.asarray(bitplane.pack(nsb & j["node_valid"][None, :])).view(np.int32))


def test_cases_stress_what_they_name():
    assert CASES["odd-n"][1] % 32
    assert CASES["wide-taints"][2] > 64
    f, _ = draw("padded-terms")
    assert (f["pod_terms"] < 0).mean() > 0.5 and (f["pod_terms"][0] < 0).all() and f["pod_has_sel"][0]
    f, base = draw("pins")
    assert base > 0 and {-2, -1, base, base - 1, base + CASES["pins"][1]} <= set(f["pod_nodename"].tolist())
    assert CASES["many-rows"][0] > 65535
    assert not draw("all-invalid")[0]["pod_valid"].any()


@pytest.mark.parametrize("with_elig", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_static_rows_plain_matches_jax(name, with_elig):
    from kubernetes_tpu_torch.ops import assign

    f, base = draw(name)
    got = assign.packed_static_rows_plain(port_arrays(f), with_elig=with_elig, base=base)
    sfs, eligs = jax_planes(f, base)
    if with_elig:
        np.testing.assert_array_equal(got[0].numpy(), sfs)
        np.testing.assert_array_equal(got[1].numpy(), eligs)
    else:
        np.testing.assert_array_equal(got.numpy(), sfs)
    if name == "all-invalid":
        assert not sfs.any()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_static_rows.py")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_static_rows_kernel_matches_plain(card, name):
    from kubernetes_tpu_torch.ops import assign, kernels

    f, base = draw(name)
    want = assign.packed_static_rows_plain(port_arrays(f), with_elig=True, base=base)
    arr = port_arrays(f, card)
    kernels.reset_launches()
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True, base=base)
    assert torch.equal(sfs.cpu(), want[0]) and torch.equal(eligs.cpu(), want[1])
    assert torch.equal(kernels.packed_static_rows(arr, base=base).cpu(), want[0])
    assert kernels.LAUNCHES["packed_static_rows"] == 2
    # the gated mode: `done` set, the launch writes nothing
    done = torch.ones((1,), dtype=torch.int32, device=card)
    out = torch.full_like(sfs, 7)
    kernels.packed_static_rows(arr, done=done, out=out, base=base)
    assert bool((out == 7).all())
    done.zero_()
    assert torch.equal(kernels.packed_static_rows(arr, done=done, out=out, base=base).cpu(), want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_class_static_hoist_kernel_matches_plain(card, name):
    """K3: the rows of the classes' first pods r_u, without the pod_valid
    term, on the same inputs."""
    from kubernetes_tpu_torch.ops import assign, kernels

    f, base = draw(name)
    P = len(f["pod_valid"])
    r_u = np.arange(0, P, 3, dtype=np.int64)
    rows = {k: (v[r_u] if k.startswith("pod_") else v) for k, v in f.items()}
    rows["pod_valid"] = np.ones(len(r_u), dtype=bool)
    want = assign.packed_static_rows_plain(port_arrays(rows), with_elig=True, base=base)
    stat, elig = kernels.class_static_hoist(port_arrays(f, card), torch.from_numpy(r_u).to(card), with_elig=True,
                                            base=base)
    assert torch.equal(stat.cpu(), want[0]) and torch.equal(elig.cpu(), want[1])
