/* C fast path for SpecInterner.group (api/snapshot.py) — the per-pod
 * identity-profile level of the two-level interning.  A copy of the JAX
 * package's native/interner.c.
 *
 * The Python loop builds a tuple and does dict operations for every pod,
 * which dominates the steady-state wave encode.  This C pass reads
 * the 13 profile fields per pod straight out of the instance __dict__
 * (borrowed refs, interned key strings), hashes the raw pointers into a
 * persistent open-addressing table, and assigns per-call canonical ids in
 * first-occurrence order — bit-identical grouping to the Python loop.
 *
 * Aliasing safety mirrors the Python version's convention (snapshot.py —
 * SpecInterner docstring): every inserted entry holds a strong reference to
 * its pod, so the field objects behind the stored pointers stay alive and a
 * recycled address can never alias a live entry.  Mutating a cached pod's
 * fields in place violates the repo-wide copy-on-write convention in both
 * implementations.
 *
 * Loaded with ctypes.PyDLL by native/pyintern.py (GIL held across calls —
 * required: every function here manipulates Python objects).  The
 * value-level slow path (sorted canonical keys for never-seen profiles)
 * stays in Python.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define NFIELDS 13

static const char *FIELD_NAMES[NFIELDS] = {
    /* pointer-profile of every field _pod_spec_key reads; value-typed
     * fields (namespace/priority/...) profile by object pointer too — a
     * different-object-equal-value miss just takes the Python slow path,
     * which computes the canonical key and maps it to the same key-id */
    "requests",     "labels",          "namespace",  "node_name",
    "priority",     "tolerations",     "node_selector", "affinity",
    "topology_spread", "host_ports",   "scheduling_gates", "pod_group",
    "images",
};

typedef struct {
    void *ptrs[NFIELDS];
    int64_t keyid;   /* -1 = empty slot */
    PyObject *pin;   /* strong ref keeping the profile's pointers alive */
} Entry;

typedef struct {
    Entry *slots;
    size_t cap;      /* power of two */
    size_t count;
    size_t n_prov;   /* unresolved provisional entries (see lookup) */
    size_t n_forced; /* identity-unstable forced misses in the LAST lookup:
                      * these bypass the pointer table entirely, so the
                      * caller polls this to latch such workloads onto the
                      * Python value-level path instead of paying the
                      * per-pod slow path every batch */
    PyObject *names[NFIELDS]; /* interned field-name strings */
} Interner;

static uint64_t profile_hash(void *const ptrs[NFIELDS]) {
    uint64_t h = 1469598103934665603ull; /* FNV-1a over the pointer words */
    for (int i = 0; i < NFIELDS; i++) {
        h ^= (uint64_t)(uintptr_t)ptrs[i];
        h *= 1099511628211ull;
        h ^= h >> 29;
    }
    return h;
}

static int profile_eq(const Entry *e, void *const ptrs[NFIELDS]) {
    return memcmp(e->ptrs, ptrs, sizeof(void *) * NFIELDS) == 0;
}

static int grow(Interner *in, size_t mincap) {
    size_t ncap = in->cap ? in->cap : 1024;
    while (ncap < mincap * 2) ncap <<= 1;
    Entry *ns = (Entry *)calloc(ncap, sizeof(Entry));
    if (!ns) return -1;
    for (size_t i = 0; i < ncap; i++) ns[i].keyid = -1;
    for (size_t i = 0; i < in->cap; i++) {
        Entry *e = &in->slots[i];
        if (e->keyid == -1) continue; /* provisional entries migrate too */
        size_t j = profile_hash(e->ptrs) & (ncap - 1);
        while (ns[j].keyid != -1) j = (j + 1) & (ncap - 1);
        ns[j] = *e;
    }
    free(in->slots);
    in->slots = ns;
    in->cap = ncap;
    return 0;
}

/* Read the profile pointers of one pod.  Returns 0 on success, 1 when the
 * profile is NOT identity-stable — a field had to be read through
 * PyObject_GetAttr, whose result can be a per-read temporary (property /
 * computed attribute): after Py_DECREF its address may be recycled by a
 * DIFFERENT object in the same batch, so storing it as an identity key
 * could falsely merge two pods with different specs.  Such pods are routed
 * to the Python value-level slow path instead (the plain-dataclass fast
 * path never takes this branch).  Returns -1 with a Python error set. */
static int read_profile(Interner *in, PyObject *pod, void *ptrs[NFIELDS]) {
    PyObject **dictp = _PyObject_GetDictPtr(pod);
    if (dictp && *dictp) {
        for (int f = 0; f < NFIELDS; f++) {
            PyObject *v = PyDict_GetItemWithError(*dictp, in->names[f]);
            if (!v) {
                if (PyErr_Occurred()) return -1;
                /* field missing from __dict__ (slots/property/odd
                 * subclass): confirm the attribute exists, then force the
                 * Python slow path — a GetAttr temporary's address is not
                 * an identity */
                v = PyObject_GetAttr(pod, in->names[f]);
                if (!v) return -1;
                Py_DECREF(v);
                return 1;
            }
            ptrs[f] = (void *)v; /* borrowed */
        }
        return 0;
    }
    /* no instance __dict__ at all (slots-backed type): every GetAttr result
     * may be a temporary — same hazard, same slow-path routing */
    return 1;
}

/* exported API (ctypes.PyDLL) ------------------------------------------- */

void *interner_new(void) {
    Interner *in = (Interner *)calloc(1, sizeof(Interner));
    if (!in) return NULL;
    for (int f = 0; f < NFIELDS; f++) {
        in->names[f] = PyUnicode_InternFromString(FIELD_NAMES[f]);
        if (!in->names[f]) return NULL;
    }
    return in;
}

void interner_clear(void *h) {
    Interner *in = (Interner *)h;
    for (size_t i = 0; i < in->cap; i++) {
        if (in->slots[i].keyid != -1) Py_CLEAR(in->slots[i].pin);
        in->slots[i].keyid = -1;
    }
    in->count = 0;
    in->n_prov = 0;
}

void interner_free(void *h) {
    Interner *in = (Interner *)h;
    interner_clear(in);
    free(in->slots);
    for (int f = 0; f < NFIELDS; f++) Py_CLEAR(in->names[f]);
    free(in);
}

int64_t interner_count(void *h) { return (int64_t)((Interner *)h)->count; }

/* Pass 1: out_keyid[i] = persistent key-id (>= 0), or a PROVISIONAL marker
 * -(m)-2 where m is the miss ordinal.  Each UNIQUE missing profile is
 * appended to miss_idx once and inserted provisionally right away, so
 * intra-batch duplicates (the common case: one spec, thousands of pods)
 * resolve to the first occurrence's marker instead of each taking the
 * Python slow path.  The first-occurrence pod is pinned immediately.
 * Returns n_miss (unique misses), or -1 with a Python error set. */
int64_t interner_lookup(void *h, PyObject *pods, int64_t *out_keyid,
                        int64_t *miss_idx) {
    Interner *in = (Interner *)h;
    Py_ssize_t n = PyList_GET_SIZE(pods);
    if (in->n_prov) {
        /* a previous batch died between lookup and insert (Python slow
         * path raised); its markers would alias this batch's.  Crash-only:
         * drop the table — every profile re-misses and re-resolves through
         * the caller's persistent spec-key registry, so grouping is
         * unaffected. */
        interner_clear(in);
    }
    if (in->cap < (size_t)(in->count + n) * 2 && grow(in, in->count + n) < 0) {
        PyErr_NoMemory();
        return -1;
    }
    int64_t n_miss = 0;
    in->n_forced = 0;
    void *ptrs[NFIELDS];
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *pod = PyList_GET_ITEM(pods, i);
        int rc = read_profile(in, pod, ptrs);
        if (rc < 0) return -1;
        if (rc == 1) {
            /* identity-unstable profile: forced miss, NOT inserted into the
             * pointer table (no provisional entry, no pin) — the Python
             * slow path resolves it by canonical value key */
            in->n_forced++;
            out_keyid[i] = -n_miss - 2;
            miss_idx[n_miss++] = i;
            continue;
        }
        size_t j = profile_hash(ptrs) & (in->cap - 1);
        while (in->slots[j].keyid != -1) {
            if (profile_eq(&in->slots[j], ptrs)) break;
            j = (j + 1) & (in->cap - 1);
        }
        if (in->slots[j].keyid != -1) {
            out_keyid[i] = in->slots[j].keyid; /* hit or earlier provisional */
        } else {
            memcpy(in->slots[j].ptrs, ptrs, sizeof(ptrs));
            in->slots[j].keyid = -n_miss - 2; /* provisional marker */
            Py_INCREF(pod);
            in->slots[j].pin = pod;
            in->count++;
            in->n_prov++;
            out_keyid[i] = -n_miss - 2;
            miss_idx[n_miss++] = i;
        }
    }
    return n_miss;
}

/* Resolve the provisional entries from this batch: pods[idx[k]] (the first
 * occurrence of unique miss k) gets persistent key-id kid[k]. */
int interner_insert(void *h, PyObject *pods, const int64_t *idx,
                    const int64_t *kid, int64_t n_ins) {
    Interner *in = (Interner *)h;
    if (in->cap < (size_t)(in->count + n_ins) * 2 &&
        grow(in, in->count + n_ins) < 0) {
        PyErr_NoMemory();
        return -1;
    }
    void *ptrs[NFIELDS];
    for (int64_t k = 0; k < n_ins; k++) {
        PyObject *pod = PyList_GET_ITEM(pods, idx[k]);
        int rc = read_profile(in, pod, ptrs);
        if (rc < 0) return -1;
        if (rc == 1) continue; /* forced miss: nothing provisional to resolve */
        size_t j = profile_hash(ptrs) & (in->cap - 1);
        while (in->slots[j].keyid != -1) {
            if (profile_eq(&in->slots[j], ptrs)) {
                if (in->slots[j].keyid < -1) in->n_prov--;
                in->slots[j].keyid = kid[k];
                break;
            }
            j = (j + 1) & (in->cap - 1);
        }
        if (in->slots[j].keyid == -1) {
            /* identity-unstable profile (e.g. a property returning a fresh
             * object per read): insert re-read different pointers than
             * lookup stored.  Store a usable entry under the re-read
             * pointers; the orphaned provisional marker keeps n_prov > 0,
             * which the caller observes via interner_prov and uses to fall
             * back to the Python path rather than thrash. */
            memcpy(in->slots[j].ptrs, ptrs, sizeof(ptrs));
            in->slots[j].keyid = kid[k];
            Py_INCREF(pod);
            in->slots[j].pin = pod;
            in->count++;
        }
    }
    return 0;
}

int64_t interner_prov(void *h) { return (int64_t)((Interner *)h)->n_prov; }

int64_t interner_forced(void *h) { return (int64_t)((Interner *)h)->n_forced; }

/* Pass 2: per-call canonical ids in first-occurrence order.
 * keyid[i] >= 0 for all i.  percall must hold max_kid+1 slots, pre-filled
 * with -1.  Writes inv[i] and rep_idx (first-occurrence pod index per rep);
 * returns n_reps. */
int64_t interner_canonicalize(const int64_t *keyid, int64_t n,
                              int64_t *percall, int64_t *inv,
                              int64_t *rep_idx) {
    int64_t n_reps = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t kid = keyid[i];
        int64_t cid = percall[kid];
        if (cid < 0) {
            cid = n_reps++;
            percall[kid] = cid;
            rep_idx[cid] = i;
        }
        inv[i] = cid;
    }
    return n_reps;
}
