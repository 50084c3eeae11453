/* h2t_host_engine: native 256-bit field arithmetic for the host-exact paths.
 *
 * The port's own copy of native/halo2_native.c, built by
 * halo2_lib_tpu_torch/native.py into _build/ under a module name of its own,
 * so its cell classes (the statics below set_classes fills) are the port's
 * and never the JAX package's. It differs from the original only in that
 * name and in leaving out the host Pippenger (msm_pack_bases, msm_commit):
 * every commitment of the port runs on the card's MSM kernels.
 *
 * The runtime around the device compute path (SURVEY.md: the reference's
 * equivalent layers are native Rust). This module accelerates the host
 * MockProver's vertical-gate stencil check and bulk modular arithmetic over
 * 32-byte little-endian scalars:
 *
 *   - gate check: q[i] * (A[i] + A[i+1]*A[i+2] - A[i+3]) == 0 over whole
 *     columns (the hot loop of backend/mock.py, SURVEY §3.1)
 *   - modmul/modadd/modsub over contiguous arrays
 *
 * Arithmetic: 4x64-bit limbs with __int128 schoolbook + Montgomery REDC
 * (R = 2^256); values enter/leave in canonical form.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

typedef struct {
    u64 p[4];      /* modulus, little-endian limbs */
    u64 n0;        /* -p^{-1} mod 2^64 */
    u64 r2[4];     /* R^2 mod p */
} FieldCtx;

static int geq(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] != b[i]) return a[i] > b[i];
    }
    return 1;
}

static void sub4(u64 out[4], const u64 a[4], const u64 b[4]) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - b[i] - borrow;
        out[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
}

static void addmod(u64 out[4], const u64 a[4], const u64 b[4], const FieldCtx *f) {
    u64 t[4];
    u128 carry = 0;
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a[i] + b[i] + carry;
        t[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || geq(t, f->p)) {
        sub4(out, t, f->p);
    } else {
        memcpy(out, t, 32);
    }
}

static void submod(u64 out[4], const u64 a[4], const u64 b[4], const FieldCtx *f) {
    u64 t[4];
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - b[i] - borrow;
        t[i] = (u64)d;
        borrow = (d >> 64) ? 1 : 0;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)t[i] + f->p[i] + carry;
            out[i] = (u64)s;
            carry = s >> 64;
        }
    } else {
        memcpy(out, t, 32);
    }
}

/* Montgomery product: out = a * b * R^{-1} mod p (CIOS). */
static void mont_mul(u64 out[4], const u64 a[4], const u64 b[4], const FieldCtx *f) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        for (int j = 0; j < 4; j++) {
            u128 s = (u128)t[j] + (u128)a[i] * b[j] + carry;
            t[j] = (u64)s;
            carry = s >> 64;
        }
        u128 s = (u128)t[4] + carry;
        t[4] = (u64)s;
        t[5] = (u64)(s >> 64);

        u64 m = t[0] * f->n0;
        carry = 0;
        u128 s0 = (u128)t[0] + (u128)m * f->p[0];
        carry = s0 >> 64;
        for (int j = 1; j < 4; j++) {
            u128 sj = (u128)t[j] + (u128)m * f->p[j] + carry;
            t[j - 1] = (u64)sj;
            carry = sj >> 64;
        }
        s0 = (u128)t[4] + carry;
        t[3] = (u64)s0;
        t[4] = t[5] + (u64)(s0 >> 64);
        t[5] = 0;
    }
    if (t[4] || geq(t, f->p)) {
        sub4(out, t, f->p);
    } else {
        memcpy(out, t, 32);
    }
}

/* canonical product: mont_mul twice via R^2 */
static void mulmod(u64 out[4], const u64 a[4], const u64 b[4], const FieldCtx *f) {
    u64 ab_r_inv[4], a_r[4];
    mont_mul(a_r, a, f->r2, f);     /* a * R */
    mont_mul(ab_r_inv, a_r, b, f);  /* a * b */
    memcpy(out, ab_r_inv, 32);
}

static void ctx_from_bytes(FieldCtx *f, const unsigned char *p_bytes, const unsigned char *r2_bytes) {
    memcpy(f->p, p_bytes, 32);
    memcpy(f->r2, r2_bytes, 32);
    /* n0 = -p^{-1} mod 2^64 via Newton iteration */
    u64 inv = 1;
    for (int i = 0; i < 6; i++) {
        inv *= 2 - f->p[0] * inv;
    }
    f->n0 = (u64)(0 - inv);
}

/* ---- Python API ------------------------------------------------------- */

/* check_gates(p32, r2_32, col_bytes, sel_bytes, nrows) -> first bad row or -1
 * col_bytes: nrows * 32 bytes LE canonical values; sel_bytes: nrows chars. */
static PyObject *py_check_gates(PyObject *self, PyObject *args) {
    Py_buffer pb, r2b, colb, selb;
    Py_ssize_t nrows;
    if (!PyArg_ParseTuple(args, "y*y*y*y*n", &pb, &r2b, &colb, &selb, &nrows))
        return NULL;
    FieldCtx f;
    ctx_from_bytes(&f, pb.buf, r2b.buf);
    const unsigned char *cols = colb.buf;
    const unsigned char *sels = selb.buf;
    Py_ssize_t bad = -1;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t r = 0; r < nrows; r++) {
        if (!sels[r]) continue;
        u64 a[4] = {0}, b[4] = {0}, c[4] = {0}, d[4] = {0};
        memcpy(a, cols + 32 * r, 32);
        if (r + 1 < nrows) memcpy(b, cols + 32 * (r + 1), 32);
        if (r + 2 < nrows) memcpy(c, cols + 32 * (r + 2), 32);
        if (r + 3 < nrows) memcpy(d, cols + 32 * (r + 3), 32);
        u64 bc[4], lhs[4], res[4];
        mulmod(bc, b, c, &f);
        addmod(lhs, a, bc, &f);
        submod(res, lhs, d, &f);
        if (res[0] | res[1] | res[2] | res[3]) { bad = r; break; }
    }
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&pb); PyBuffer_Release(&r2b);
    PyBuffer_Release(&colb); PyBuffer_Release(&selb);
    return PyLong_FromSsize_t(bad);
}

/* elementwise modmul/addmod/submod over arrays of 32-byte values */
#define DEF_VEC_OP(name, op)                                                  \
static PyObject *py_##name(PyObject *self, PyObject *args) {                  \
    Py_buffer pb, r2b, ab, bb;                                                \
    if (!PyArg_ParseTuple(args, "y*y*y*y*", &pb, &r2b, &ab, &bb))             \
        return NULL;                                                          \
    if (ab.len != bb.len || ab.len % 32) {                                    \
        PyErr_SetString(PyExc_ValueError, "bad buffer sizes");                \
        PyBuffer_Release(&pb); PyBuffer_Release(&r2b);                        \
        PyBuffer_Release(&ab); PyBuffer_Release(&bb);                         \
        return NULL;                                                          \
    }                                                                         \
    FieldCtx f;                                                               \
    ctx_from_bytes(&f, pb.buf, r2b.buf);                                      \
    Py_ssize_t n = ab.len / 32;                                               \
    PyObject *out = PyBytes_FromStringAndSize(NULL, ab.len);                  \
    if (!out) goto done;                                                      \
    {                                                                         \
        unsigned char *o = (unsigned char *)PyBytes_AS_STRING(out);           \
        const unsigned char *ap = ab.buf, *bp = bb.buf;                       \
        Py_BEGIN_ALLOW_THREADS                                                \
        for (Py_ssize_t i = 0; i < n; i++) {                                  \
            u64 x[4], y[4], z[4];                                             \
            memcpy(x, ap + 32 * i, 32);                                       \
            memcpy(y, bp + 32 * i, 32);                                       \
            op(z, x, y, &f);                                                  \
            memcpy(o + 32 * i, z, 32);                                        \
        }                                                                     \
        Py_END_ALLOW_THREADS                                                  \
    }                                                                         \
done:                                                                         \
    PyBuffer_Release(&pb); PyBuffer_Release(&r2b);                            \
    PyBuffer_Release(&ab); PyBuffer_Release(&bb);                             \
    return out;                                                               \
}

DEF_VEC_OP(modmul_vec, mulmod)
DEF_VEC_OP(modadd_vec, addmod)
DEF_VEC_OP(modsub_vec, submod)

/* ---- witness-engine emitters ------------------------------------------ *
 *
 * Bulk cell emission for the hot gadget layouts (the role of the reference's
 * native witness generation, halo2-base flex_gate/mod.rs:940-978). The
 * Python gadget keeps the API and the layout spec; the per-cell work
 * (field arithmetic, advice/selector appends, copy-constraint tuples)
 * happens here. Python falls back to its pure path whenever the emitter
 * returns -1 (Rational values, oversized ints, unexpected shapes).
 */

static PyObject *g_contextcell = NULL;   /* core.cells.ContextCell */
static PyObject *g_qcell = NULL;         /* core.cells.QCell */
static PyObject *g_assignedvalue = NULL; /* core.cells.AssignedValue */
static PyObject *s_kind, *s_val, *s_value, *s_cell, *s_advice, *s_selector,
    *s_copy_manager, *s_adv_eq, *s_const_eq, *s_type_id, *s_context_id,
    *s_wg_only;

static PyObject *py_set_classes(PyObject *self, PyObject *args) {
    PyObject *cc, *qc = NULL, *av = NULL;
    if (!PyArg_ParseTuple(args, "O|OO", &cc, &qc, &av)) return NULL;
    Py_XDECREF(g_contextcell);
    g_contextcell = cc;
    Py_INCREF(cc);
    if (qc) {
        Py_XDECREF(g_qcell);
        g_qcell = qc;
        Py_INCREF(qc);
    }
    if (av) {
        Py_XDECREF(g_assignedvalue);
        g_assignedvalue = av;
        Py_INCREF(av);
    }
    Py_RETURN_NONE;
}

/* ContextCell(type_id, context_id, offset) without the Python-level
 * namedtuple __new__: tuple.__new__(cls, (tid, cid, off)). */
static PyObject *make_cell(PyObject *tid, PyObject *cid, Py_ssize_t off) {
    PyObject *off_o = PyLong_FromSsize_t(off);
    if (!off_o) return NULL;
    PyObject *inner = PyTuple_Pack(3, tid, cid, off_o);
    Py_DECREF(off_o);
    if (!inner) return NULL;
    PyObject *args = PyTuple_Pack(1, inner);
    Py_DECREF(inner);
    if (!args) return NULL;
    PyObject *cell = PyTuple_Type.tp_new((PyTypeObject *)g_contextcell, args, NULL);
    Py_DECREF(args);
    return cell;
}

/* canonical u64[4] from a PyLong in [0, 2^256); reduces mod p. 0 ok, -1 fallback */
static int load_fe(PyObject *obj, u64 out[4], const FieldCtx *f) {
    if (!PyLong_Check(obj)) return -1;
    unsigned char buf[32];
    /* the five-argument form of CPython 3.12 (3.13 adds with_exceptions) */
    if (_PyLong_AsByteArray((PyLongObject *)obj, buf, 32, 1, 0) < 0) {
        PyErr_Clear();
        return -1;
    }
    memcpy(out, buf, 32);
    while (geq(out, f->p) && (out[3] | out[2] | out[1] | out[0]))
        sub4(out, out, f->p);
    return 0;
}

static PyObject *fe_to_long(const u64 v[4]) {
    return _PyLong_FromByteArray((const unsigned char *)v, 32, 1, 0);
}

enum { K_EXISTING = 0, K_WITNESS = 1, K_FRACTION = 2, K_CONSTANT = 3 };

/* One parsed QCell. */
typedef struct {
    long kind;
    PyObject *value;   /* borrowed: the int value object */
    PyObject *cell;    /* borrowed: ContextCell for Existing, else NULL */
    u64 fe[4];
} QC;

/* parse one QCell; 0 ok, -1 fallback-to-python */
static int parse_qc(PyObject *q, QC *out, const FieldCtx *f, int need_fe) {
    PyObject *kind_o = PyObject_GetAttr(q, s_kind);
    if (!kind_o) return -1;
    out->kind = PyLong_AsLong(kind_o);
    Py_DECREF(kind_o);
    PyObject *val = PyObject_GetAttr(q, s_val);
    if (!val) return -1;
    out->cell = NULL;
    if (out->kind == K_EXISTING) {
        /* val is an AssignedValue: .value (int) + .cell */
        PyObject *v = PyObject_GetAttr(val, s_value);
        if (!v) { Py_DECREF(val); return -1; }
        PyObject *cell = PyObject_GetAttr(val, s_cell);
        Py_DECREF(val);
        if (!cell) { Py_DECREF(v); return -1; }
        /* borrow via the ctx-owned objects: the AssignedValue keeps them alive
         * for the duration of the call (caller holds the QCell list). */
        Py_DECREF(v);
        Py_DECREF(cell);
        out->value = v;
        out->cell = (cell == Py_None) ? NULL : cell;
    } else if (out->kind == K_WITNESS || out->kind == K_CONSTANT) {
        Py_DECREF(val);
        out->value = val;
    } else {
        Py_DECREF(val);
        return -1; /* WitnessFraction: python path handles batch inversion */
    }
    if (need_fe && load_fe(out->value, out->fe, f) < 0) return -1;
    return 0;
}

/* emit_inner_product(p32, r2_32, ctx, a_list, b_list)
 *   -> 1 if b[0]==Constant(1) layout, 0 otherwise, -1 = caller must fall back
 * Appends the running-sum inner-product region (flex_gate/mod.rs:940-978):
 * cells, vertical-gate selectors every 3 rows, copy tuples for
 * Existing/Constant inputs. Python side does nothing else afterwards. */
static PyObject *py_emit_inner_product(PyObject *self, PyObject *args) {
    Py_buffer pb, r2b;
    PyObject *ctx, *alist, *blist;
    if (!PyArg_ParseTuple(args, "y*y*OOO", &pb, &r2b, &ctx, &alist, &blist))
        return NULL;
    FieldCtx f;
    ctx_from_bytes(&f, pb.buf, r2b.buf);
    PyBuffer_Release(&pb);
    PyBuffer_Release(&r2b);

    long result = -1;
    PyObject *advice = NULL, *selector = NULL, *cm = NULL, *adv_eq = NULL,
             *const_eq = NULL, *tid = NULL, *cid = NULL;
    QC *aq = NULL, *bq = NULL;

    if (!g_contextcell || !PyList_Check(alist) || !PyList_Check(blist)) goto fallback;
    Py_ssize_t n = PyList_GET_SIZE(alist);
    if (PyList_GET_SIZE(blist) != n || n == 0) goto fallback;

    advice = PyObject_GetAttr(ctx, s_advice);
    selector = PyObject_GetAttr(ctx, s_selector);
    cm = PyObject_GetAttr(ctx, s_copy_manager);
    tid = PyObject_GetAttr(ctx, s_type_id);
    cid = PyObject_GetAttr(ctx, s_context_id);
    PyObject *wg_o = PyObject_GetAttr(ctx, s_wg_only);
    if (!advice || !selector || !cm || !tid || !cid || !wg_o) {
        Py_XDECREF(wg_o);
        goto fallback;
    }
    int wg_only = PyObject_IsTrue(wg_o);
    Py_DECREF(wg_o);
    if (!wg_only) {
        adv_eq = PyObject_GetAttr(cm, s_adv_eq);
        const_eq = PyObject_GetAttr(cm, s_const_eq);
        if (!adv_eq || !const_eq) goto fallback;
    }
    if (!PyList_Check(advice)) goto fallback;

    aq = PyMem_Malloc(sizeof(QC) * (size_t)n);
    bq = PyMem_Malloc(sizeof(QC) * (size_t)n);
    if (!aq || !bq) goto fallback;
    for (Py_ssize_t i = 0; i < n; i++) {
        if (parse_qc(PyList_GET_ITEM(alist, i), &aq[i], &f, 1) < 0) goto fallback;
        if (parse_qc(PyList_GET_ITEM(blist, i), &bq[i], &f, 1) < 0) goto fallback;
    }

    int b0_one = (bq[0].kind == K_CONSTANT && bq[0].fe[0] == 1 &&
                  !(bq[0].fe[1] | bq[0].fe[2] | bq[0].fe[3]));
    Py_ssize_t row0 = PyList_GET_SIZE(advice);

    /* helper macro: append value object + optional copy bookkeeping */
#define APPEND_CELL(qc_value, qc_kind, qc_cell)                                \
    do {                                                                       \
        if (PyList_Append(advice, (qc_value)) < 0) goto hard_error;            \
        if (!wg_only) {                                                        \
            if ((qc_kind) == K_EXISTING && (qc_cell)) {                        \
                PyObject *me = make_cell(tid, cid, PyList_GET_SIZE(advice) - 1); \
                if (!me) goto hard_error;                                      \
                PyObject *pair = PyTuple_Pack(2, me, (qc_cell));               \
                Py_DECREF(me);                                                 \
                if (!pair) goto hard_error;                                    \
                int rc = PyList_Append(adv_eq, pair);                          \
                Py_DECREF(pair);                                               \
                if (rc < 0) goto hard_error;                                   \
            } else if ((qc_kind) == K_CONSTANT) {                              \
                PyObject *me = make_cell(tid, cid, PyList_GET_SIZE(advice) - 1); \
                if (!me) goto hard_error;                                      \
                PyObject *pair = PyTuple_Pack(2, (qc_value), me);              \
                Py_DECREF(me);                                                 \
                if (!pair) goto hard_error;                                    \
                int rc = PyList_Append(const_eq, pair);                        \
                Py_DECREF(pair);                                               \
                if (rc < 0) goto hard_error;                                   \
            }                                                                  \
        }                                                                      \
    } while (0)

    u64 s[4];
    Py_ssize_t start;
    if (b0_one) {
        APPEND_CELL(aq[0].value, aq[0].kind, aq[0].cell);
        memcpy(s, aq[0].fe, 32);
        start = 1;
    } else {
        PyObject *zero = PyLong_FromLong(0);
        if (!zero) goto hard_error;
        APPEND_CELL(zero, K_CONSTANT, NULL);
        Py_DECREF(zero);
        memset(s, 0, 32);
        start = 0;
    }
    for (Py_ssize_t i = start; i < n; i++) {
        u64 prod[4];
        mulmod(prod, aq[i].fe, bq[i].fe, &f);
        addmod(s, s, prod, &f);
        APPEND_CELL(aq[i].value, aq[i].kind, aq[i].cell);
        APPEND_CELL(bq[i].value, bq[i].kind, bq[i].cell);
        PyObject *sv = fe_to_long(s);
        if (!sv) goto hard_error;
        APPEND_CELL(sv, K_WITNESS, NULL);
        Py_DECREF(sv);
    }
#undef APPEND_CELL

    if (!wg_only) {
        /* selector: pad False to advice length, True at row0 + 3*i */
        Py_ssize_t alen = PyList_GET_SIZE(advice);
        Py_ssize_t slen = PyList_GET_SIZE(selector);
        for (Py_ssize_t r = slen; r < alen; r++) {
            if (PyList_Append(selector, Py_False) < 0) goto hard_error;
        }
        Py_ssize_t ngates = (alen - row0) / 3;
        for (Py_ssize_t g = 0; g < ngates; g++) {
            Py_INCREF(Py_True);
            if (PyList_SetItem(selector, row0 + 3 * g, Py_True) < 0) goto hard_error;
        }
    }
    result = b0_one;
    goto done;

hard_error:
    Py_XDECREF(advice); Py_XDECREF(selector); Py_XDECREF(cm);
    Py_XDECREF(adv_eq); Py_XDECREF(const_eq); Py_XDECREF(tid); Py_XDECREF(cid);
    PyMem_Free(aq); PyMem_Free(bq);
    return NULL;

fallback:
    PyErr_Clear();
done:
    Py_XDECREF(advice); Py_XDECREF(selector); Py_XDECREF(cm);
    Py_XDECREF(adv_eq); Py_XDECREF(const_eq); Py_XDECREF(tid); Py_XDECREF(cid);
    PyMem_Free(aq); PyMem_Free(bq);
    return PyLong_FromLong(result);
}

/* emit_range_check(p32, r2_32, ctx, a_av, blist, num_limbs, lookup_bits,
 *                  lookup_rows) -> last-limb AssignedValue, or None = fall back
 *
 * The whole multi-limb range_check hot path (range/mod.rs:512-564) in one
 * call: decompose a into lookup_bits limbs, emit the b[0]==1 inner-product
 * region against the Constant limb bases, record the a == acc copy, build
 * the limb AssignedValues and append them as rows to the lookup manager's
 * bucket list. Python keeps only the rem_bits tail. */
static PyObject *py_emit_range_check(PyObject *self, PyObject *args) {
    Py_buffer pb, r2b;
    PyObject *ctx, *a_av, *blist, *rows;
    long num_limbs, lookup_bits;
    if (!PyArg_ParseTuple(args, "y*y*OOOllO", &pb, &r2b, &ctx, &a_av, &blist,
                          &num_limbs, &lookup_bits, &rows))
        return NULL;
    FieldCtx f;
    ctx_from_bytes(&f, pb.buf, r2b.buf);
    PyBuffer_Release(&pb);
    PyBuffer_Release(&r2b);

    PyObject *advice = NULL, *selector = NULL, *cm = NULL, *adv_eq = NULL,
             *const_eq = NULL, *tid = NULL, *cid = NULL, *resobj = NULL;
    QC *bq = NULL;
    PyObject **limb_longs = NULL;

    /* num_limbs > 64 would overflow the limbs[64] stack buffer below (and
     * emit garbage witness limbs): such oversized decompositions (tiny
     * lookup_bits with 200+ bit ranges) take the Python path instead. */
    if (!g_contextcell || !g_assignedvalue || !PyList_Check(blist) ||
        !PyList_Check(rows) || num_limbs < 2 || num_limbs > 64 ||
        PyList_GET_SIZE(blist) < num_limbs || lookup_bits < 1 || lookup_bits > 62)
        goto fallback;

    /* a: value must be a plain int (Rational witnesses fall back) */
    PyObject *a_val = PyObject_GetAttr(a_av, s_value);
    PyObject *a_cell = PyObject_GetAttr(a_av, s_cell);
    if (!a_val || !PyLong_Check(a_val)) {
        Py_XDECREF(a_val); Py_XDECREF(a_cell);
        goto fallback;
    }
    u64 afe[4];
    if (load_fe(a_val, afe, &f) < 0) {
        Py_DECREF(a_val); Py_XDECREF(a_cell);
        goto fallback;
    }

    advice = PyObject_GetAttr(ctx, s_advice);
    selector = PyObject_GetAttr(ctx, s_selector);
    cm = PyObject_GetAttr(ctx, s_copy_manager);
    tid = PyObject_GetAttr(ctx, s_type_id);
    cid = PyObject_GetAttr(ctx, s_context_id);
    PyObject *wg_o = PyObject_GetAttr(ctx, s_wg_only);
    int wg_only = 0;
    if (!advice || !selector || !cm || !tid || !cid || !wg_o) {
        Py_XDECREF(wg_o); Py_DECREF(a_val); Py_XDECREF(a_cell);
        goto fallback;
    }
    wg_only = PyObject_IsTrue(wg_o);
    Py_DECREF(wg_o);
    if (!wg_only) {
        adv_eq = PyObject_GetAttr(cm, s_adv_eq);
        const_eq = PyObject_GetAttr(cm, s_const_eq);
        if (!adv_eq || !const_eq) { Py_DECREF(a_val); Py_XDECREF(a_cell); goto fallback; }
    }
    if (!PyList_Check(advice)) { Py_DECREF(a_val); Py_XDECREF(a_cell); goto fallback; }

    bq = PyMem_Malloc(sizeof(QC) * (size_t)num_limbs);
    limb_longs = PyMem_Calloc((size_t)num_limbs, sizeof(PyObject *));
    if (!bq || !limb_longs) { Py_DECREF(a_val); Py_XDECREF(a_cell); goto fallback; }
    for (long i = 0; i < num_limbs; i++) {
        if (parse_qc(PyList_GET_ITEM(blist, i), &bq[i], &f, 1) < 0) {
            Py_DECREF(a_val); Py_XDECREF(a_cell);
            goto fallback;
        }
    }
    int b0_one = (bq[0].kind == K_CONSTANT && bq[0].fe[0] == 1 &&
                  !(bq[0].fe[1] | bq[0].fe[2] | bq[0].fe[3]));
    if (!b0_one) { Py_DECREF(a_val); Py_XDECREF(a_cell); goto fallback; }

    /* decompose: limb_j = (a >> j*lookup_bits) & mask (truncating, same as
     * decompose_fe_to_u64_limbs) */
    u64 mask = (lookup_bits == 64) ? ~0ULL : ((1ULL << lookup_bits) - 1);
    u64 limbs[64];
    for (long j = 0; j < num_limbs && j < 64; j++) {
        long bit = j * lookup_bits;
        long w = bit / 64, off = bit % 64;
        u64 v = (w < 4) ? (afe[w] >> off) : 0;
        if (off && w + 1 < 4) v |= afe[w + 1] << (64 - off);
        limbs[j] = v & mask;
    }
    for (long j = 0; j < num_limbs; j++) {
        limb_longs[j] = PyLong_FromUnsignedLongLong(limbs[j]);
        if (!limb_longs[j]) { Py_DECREF(a_val); Py_XDECREF(a_cell); goto hard_error; }
    }

    Py_ssize_t row0 = PyList_GET_SIZE(advice);

#define RC_APPEND(v, kind, cell_o)                                             \
    do {                                                                       \
        if (PyList_Append(advice, (v)) < 0) goto hard_error2;                  \
        if (!wg_only && (kind) == K_CONSTANT) {                                \
            PyObject *me = make_cell(tid, cid, PyList_GET_SIZE(advice) - 1);   \
            if (!me) goto hard_error2;                                         \
            PyObject *pair = PyTuple_Pack(2, (v), me);                         \
            Py_DECREF(me);                                                     \
            if (!pair) goto hard_error2;                                       \
            int rc = PyList_Append(const_eq, pair);                            \
            Py_DECREF(pair);                                                   \
            if (rc < 0) goto hard_error2;                                      \
        }                                                                      \
    } while (0)

    {
        u64 s[4], limbfe[4];
        /* row 0: limb 0 (witness) */
        RC_APPEND(limb_longs[0], K_WITNESS, NULL);
        memset(s, 0, 32);
        s[0] = limbs[0];
        for (long i = 1; i < num_limbs; i++) {
            u64 prod[4];
            memset(limbfe, 0, 32);
            limbfe[0] = limbs[i];
            mulmod(prod, limbfe, bq[i].fe, &f);
            addmod(s, s, prod, &f);
            RC_APPEND(limb_longs[i], K_WITNESS, NULL);
            RC_APPEND(bq[i].value, bq[i].kind, bq[i].cell);
            PyObject *sv = fe_to_long(s);
            if (!sv) goto hard_error2;
            int rc = PyList_Append(advice, sv);
            Py_DECREF(sv);
            if (rc < 0) goto hard_error2;
        }
    }
#undef RC_APPEND

    if (!wg_only) {
        /* selector pad + gates every 3 rows */
        Py_ssize_t alen = PyList_GET_SIZE(advice);
        Py_ssize_t slen = PyList_GET_SIZE(selector);
        for (Py_ssize_t r = slen; r < alen; r++)
            if (PyList_Append(selector, Py_False) < 0) goto hard_error2;
        Py_ssize_t ngates = (alen - row0) / 3;
        for (Py_ssize_t g = 0; g < ngates; g++) {
            Py_INCREF(Py_True);
            if (PyList_SetItem(selector, row0 + 3 * g, Py_True) < 0) goto hard_error2;
        }
        /* a == acc (the last running sum) */
        if (a_cell && a_cell != Py_None) {
            PyObject *acc_cell = make_cell(tid, cid, PyList_GET_SIZE(advice) - 1);
            if (!acc_cell) goto hard_error2;
            PyObject *pair = PyTuple_Pack(2, a_cell, acc_cell);
            Py_DECREF(acc_cell);
            if (!pair) goto hard_error2;
            int rc = PyList_Append(adv_eq, pair);
            Py_DECREF(pair);
            if (rc < 0) goto hard_error2;
        }
    }

    /* limb AssignedValues -> lookup rows; limb i>=1 sits at row0 + 1 + 3(i-1) */
    for (long i = 0; i < num_limbs; i++) {
        Py_ssize_t off = (i == 0) ? row0 : row0 + 1 + 3 * (i - 1);
        PyObject *cell_o;
        if (wg_only) {
            cell_o = Py_None;
            Py_INCREF(Py_None);
        } else {
            cell_o = make_cell(tid, cid, off);
            if (!cell_o) goto hard_error2;
        }
        PyObject *av = PyObject_CallFunctionObjArgs(
            g_assignedvalue, limb_longs[i], cell_o, NULL);
        Py_DECREF(cell_o);
        if (!av) goto hard_error2;
        if (i == num_limbs - 1) {
            resobj = av;
            Py_INCREF(av);
        }
        PyObject *tup = PyTuple_Pack(1, av);
        Py_DECREF(av);
        if (!tup) goto hard_error2;
        int rc = PyList_Append(rows, tup);
        Py_DECREF(tup);
        if (rc < 0) goto hard_error2;
    }

    Py_DECREF(a_val);
    Py_XDECREF(a_cell);
    goto done;

hard_error2:
    Py_DECREF(a_val);
    Py_XDECREF(a_cell);
hard_error:
    Py_XDECREF(resobj);
    Py_XDECREF(advice); Py_XDECREF(selector); Py_XDECREF(cm);
    Py_XDECREF(adv_eq); Py_XDECREF(const_eq); Py_XDECREF(tid); Py_XDECREF(cid);
    if (limb_longs) {
        for (long j = 0; j < num_limbs; j++) Py_XDECREF(limb_longs[j]);
        PyMem_Free(limb_longs);
    }
    PyMem_Free(bq);
    return NULL;

fallback:
    PyErr_Clear();
    resobj = Py_None;
    Py_INCREF(Py_None);
done:
    Py_XDECREF(advice); Py_XDECREF(selector); Py_XDECREF(cm);
    Py_XDECREF(adv_eq); Py_XDECREF(const_eq); Py_XDECREF(tid); Py_XDECREF(cid);
    if (limb_longs) {
        for (long j = 0; j < num_limbs; j++) Py_XDECREF(limb_longs[j]);
        PyMem_Free(limb_longs);
    }
    PyMem_Free(bq);
    return resobj;
}

/* emit_region(ctx, cells, gate_offsets) -> n appended, or -1 = fall back.
 *
 * The generic Context.assign_region core (halo2-base lib.rs:310-335): append
 * every QuantumCell value, record Existing/Constant copy tuples, pad the
 * selector and enable the vertical gate at row0 + offset. No field
 * arithmetic — values are appended as-is (Rationals included). */
static PyObject *py_emit_region(PyObject *self, PyObject *args) {
    PyObject *ctx, *cells, *offsets;
    if (!PyArg_ParseTuple(args, "OOO", &ctx, &cells, &offsets))
        return NULL;

    long result = -1;
    PyObject *advice = NULL, *selector = NULL, *cm = NULL, *adv_eq = NULL,
             *const_eq = NULL, *tid = NULL, *cid = NULL;

    if (!g_contextcell || !g_qcell || !g_assignedvalue) goto fallback;
    if (!PyList_Check(cells) || !PyList_Check(offsets)) goto fallback;
    Py_ssize_t n = PyList_GET_SIZE(cells);

    advice = PyObject_GetAttr(ctx, s_advice);
    PyObject *wg_o = PyObject_GetAttr(ctx, s_wg_only);
    if (!advice || !wg_o || !PyList_Check(advice)) {
        Py_XDECREF(wg_o);
        goto fallback;
    }
    int wg_only = PyObject_IsTrue(wg_o);
    Py_DECREF(wg_o);
    if (!wg_only) {
        selector = PyObject_GetAttr(ctx, s_selector);
        cm = PyObject_GetAttr(ctx, s_copy_manager);
        tid = PyObject_GetAttr(ctx, s_type_id);
        cid = PyObject_GetAttr(ctx, s_context_id);
        if (!selector || !cm || !tid || !cid || !PyList_Check(selector)) goto fallback;
        adv_eq = PyObject_GetAttr(cm, s_adv_eq);
        const_eq = PyObject_GetAttr(cm, s_const_eq);
        if (!adv_eq || !const_eq) goto fallback;
    }

    Py_ssize_t row0 = PyList_GET_SIZE(advice);

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *q = PyList_GET_ITEM(cells, i);
        long kind;
        PyObject *value, *cellp = NULL; /* borrowed */
        if (Py_TYPE(q) == (PyTypeObject *)g_qcell) {
            PyObject *kind_o = PyObject_GetAttr(q, s_kind);
            if (!kind_o) goto hard_error;
            kind = PyLong_AsLong(kind_o);
            Py_DECREF(kind_o);
            PyObject *val = PyObject_GetAttr(q, s_val);
            if (!val) goto hard_error;
            Py_DECREF(val); /* borrowed via q */
            if (kind == K_EXISTING) {
                PyObject *v = PyObject_GetAttr(val, s_value);
                if (!v) goto hard_error;
                Py_DECREF(v);
                PyObject *cell = PyObject_GetAttr(val, s_cell);
                if (!cell) goto hard_error;
                Py_DECREF(cell);
                value = v;
                cellp = (cell == Py_None) ? NULL : cell;
            } else {
                value = val;
            }
        } else if (Py_TYPE(q) == (PyTypeObject *)g_assignedvalue) {
            kind = K_EXISTING;
            PyObject *v = PyObject_GetAttr(q, s_value);
            if (!v) goto hard_error;
            Py_DECREF(v);
            PyObject *cell = PyObject_GetAttr(q, s_cell);
            if (!cell) goto hard_error;
            Py_DECREF(cell);
            value = v;
            cellp = (cell == Py_None) ? NULL : cell;
        } else {
            /* unknown input type mid-region: bail out only if nothing was
             * appended yet; otherwise raise (should not happen — as_qcell
             * accepts exactly these two types) */
            if (i == 0) goto fallback;
            PyErr_SetString(PyExc_TypeError, "emit_region: unsupported cell type");
            goto hard_error;
        }

        if (PyList_Append(advice, value) < 0) goto hard_error;
        if (!wg_only) {
            if (kind == K_EXISTING && cellp) {
                PyObject *me = make_cell(tid, cid, PyList_GET_SIZE(advice) - 1);
                if (!me) goto hard_error;
                PyObject *pair = PyTuple_Pack(2, me, cellp);
                Py_DECREF(me);
                if (!pair) goto hard_error;
                int rc = PyList_Append(adv_eq, pair);
                Py_DECREF(pair);
                if (rc < 0) goto hard_error;
            } else if (kind == K_CONSTANT) {
                PyObject *me = make_cell(tid, cid, PyList_GET_SIZE(advice) - 1);
                if (!me) goto hard_error;
                PyObject *pair = PyTuple_Pack(2, value, me);
                Py_DECREF(me);
                if (!pair) goto hard_error;
                int rc = PyList_Append(const_eq, pair);
                Py_DECREF(pair);
                if (rc < 0) goto hard_error;
            }
        }
    }

    if (!wg_only) {
        Py_ssize_t alen = PyList_GET_SIZE(advice);
        for (Py_ssize_t r = PyList_GET_SIZE(selector); r < alen; r++) {
            if (PyList_Append(selector, Py_False) < 0) goto hard_error;
        }
        Py_ssize_t noff = PyList_GET_SIZE(offsets);
        for (Py_ssize_t g = 0; g < noff; g++) {
            long off = PyLong_AsLong(PyList_GET_ITEM(offsets, g));
            if (off == -1 && PyErr_Occurred()) goto hard_error;
            Py_ssize_t idx = row0 + off;
            if (idx < 0 || idx >= PyList_GET_SIZE(selector)) {
                PyErr_SetString(PyExc_IndexError, "gate offset out of range");
                goto hard_error;
            }
            Py_INCREF(Py_True);
            if (PyList_SetItem(selector, idx, Py_True) < 0) goto hard_error;
        }
    }
    result = (long)n;
    goto done;

hard_error:
    Py_XDECREF(advice); Py_XDECREF(selector); Py_XDECREF(cm);
    Py_XDECREF(adv_eq); Py_XDECREF(const_eq); Py_XDECREF(tid); Py_XDECREF(cid);
    return NULL;

fallback:
    PyErr_Clear();
done:
    Py_XDECREF(advice); Py_XDECREF(selector); Py_XDECREF(cm);
    Py_XDECREF(adv_eq); Py_XDECREF(const_eq); Py_XDECREF(tid); Py_XDECREF(cid);
    return PyLong_FromLong(result);
}

/* pack a list of PyLongs in [0, 2^256) into 32 little-endian bytes each
 * (= 16 little-endian u16 limbs): the bulk host->device witness packing.
 * ~10x faster than per-int int.to_bytes in Python. */
static PyObject *py_pack_limbs16(PyObject *self, PyObject *args) {
    PyObject *list;
    if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &list)) return NULL;
    Py_ssize_t n = PyList_GET_SIZE(list);
    PyObject *out = PyBytes_FromStringAndSize(NULL, n * 32);
    if (!out) return NULL;
    unsigned char *buf = (unsigned char *)PyBytes_AS_STRING(out);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *v = PyList_GET_ITEM(list, i);
        /* the five-argument form of CPython 3.12, as in load_fe */
        if (!PyLong_Check(v) ||
            _PyLong_AsByteArray((PyLongObject *)v, buf + 32 * i, 32, 1, 0) < 0) {
            Py_DECREF(out);
            PyErr_Format(PyExc_ValueError, "pack_limbs16: bad value at %zd", i);
            return NULL;
        }
    }
    return out;
}

static PyMethodDef Methods[] = {
    {"pack_limbs16", py_pack_limbs16, METH_VARARGS,
     "list of ints < 2^256 -> bytes of 16 LE u16 limbs each"},
    {"check_gates", py_check_gates, METH_VARARGS,
     "first failing gate row of one column, or -1"},
    {"modmul_vec", py_modmul_vec, METH_VARARGS, "elementwise a*b mod p"},
    {"modadd_vec", py_modadd_vec, METH_VARARGS, "elementwise a+b mod p"},
    {"modsub_vec", py_modsub_vec, METH_VARARGS, "elementwise a-b mod p"},
    {"set_classes", py_set_classes, METH_VARARGS, "register ContextCell class"},
    {"emit_inner_product", py_emit_inner_product, METH_VARARGS,
     "native running-sum inner-product region emitter"},
    {"emit_region", py_emit_region, METH_VARARGS,
     "native generic assign_region emitter"},
    {"emit_range_check", py_emit_range_check, METH_VARARGS,
     "native range_check: decompose + inner product + lookup rows"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "h2t_host_engine", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit_h2t_host_engine(void) {
    s_kind = PyUnicode_InternFromString("kind");
    s_val = PyUnicode_InternFromString("val");
    s_value = PyUnicode_InternFromString("value");
    s_cell = PyUnicode_InternFromString("cell");
    s_advice = PyUnicode_InternFromString("advice");
    s_selector = PyUnicode_InternFromString("selector");
    s_copy_manager = PyUnicode_InternFromString("copy_manager");
    s_adv_eq = PyUnicode_InternFromString("advice_equalities");
    s_const_eq = PyUnicode_InternFromString("constant_equalities");
    s_type_id = PyUnicode_InternFromString("type_id");
    s_context_id = PyUnicode_InternFromString("context_id");
    s_wg_only = PyUnicode_InternFromString("witness_gen_only");
    return PyModule_Create(&moduledef);
}
