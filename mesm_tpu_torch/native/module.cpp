// Native host-side compute for the mesm_tpu_torch input/eval pipeline (a
// copy of mesm_tpu/native/module.cpp).
//
// The reference keeps these on the Python hot path: greedy temporal NMS
// (reference utils/temporal_nms.py:25-74, pure-Python list popping), per-query
// VOC AP assignment (reference eval.py:326-409, farmed to an mp.Pool of 8),
// and per-item mean-pool video downsampling (reference dataset/base.py:100-114,
// a Python loop per segment). Here they are C++ behind the buffer protocol,
// with numpy fallbacks beside each call site (mesm_tpu_torch/native/__init__.py).
//
// All functions are exact ports of the semantics (including the reference's
// loose "union = enclosing interval" IoU used by NMS).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct BufferGuard {
  Py_buffer view{};
  bool ok = false;
  ~BufferGuard() {
    if (ok) PyBuffer_Release(&view);
  }
};

bool get_2d(PyObject* obj, BufferGuard& g, Py_ssize_t expect_cols,
            const char* name) {
  if (PyObject_GetBuffer(obj, &g.view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0)
    return false;
  g.ok = true;
  if (g.view.ndim != 2 || g.view.shape[1] != expect_cols ||
      std::strcmp(g.view.format ? g.view.format : "", "d") != 0) {
    PyErr_Format(PyExc_ValueError, "%s must be C-contiguous float64 (N, %zd)",
                 name, (Py_ssize_t)expect_cols);
    return false;
  }
  return true;
}

inline double loose_iou(const double* a, const double* b) {
  const double inter =
      std::max(0.0, std::min(a[1], b[1]) - std::max(a[0], b[0]));
  const double uni = std::max(a[1], b[1]) - std::min(a[0], b[0]);
  return uni != 0.0 ? inter / uni : 0.0;
}

inline double true_iou(const double* a, const double* b) {
  const double inter =
      std::max(0.0, std::min(a[1], b[1]) - std::max(a[0], b[0]));
  const double uni = (a[1] - a[0]) + (b[1] - b[0]) - inter;
  return uni != 0.0 ? inter / uni : 0.0;
}

// temporal_nms(windows: (N,3) float64 sorted however, thd, max_after) ->
// list[int] kept row indices in output (score-descending) order.
PyObject* temporal_nms(PyObject*, PyObject* args) {
  PyObject* arr;
  double thd;
  Py_ssize_t max_after;
  if (!PyArg_ParseTuple(args, "Odn", &arr, &thd, &max_after)) return nullptr;
  BufferGuard g;
  if (!get_2d(arr, g, 3, "windows")) return nullptr;
  const double* w = static_cast<const double*>(g.view.buf);
  const Py_ssize_t n = g.view.shape[0];

  std::vector<Py_ssize_t> order(n);
  for (Py_ssize_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](Py_ssize_t a, Py_ssize_t b) {
    return w[a * 3 + 2] > w[b * 3 + 2];
  });

  std::vector<char> alive(n, 1);
  std::vector<Py_ssize_t> kept;
  for (Py_ssize_t oi = 0; oi < n && (Py_ssize_t)kept.size() < max_after; ++oi) {
    const Py_ssize_t i = order[oi];
    if (!alive[i]) continue;
    kept.push_back(i);
    for (Py_ssize_t oj = oi + 1; oj < n; ++oj) {
      const Py_ssize_t j = order[oj];
      if (alive[j] && loose_iou(w + i * 3, w + j * 3) > thd) alive[j] = 0;
    }
  }
  PyObject* out = PyList_New((Py_ssize_t)kept.size());
  if (!out) return nullptr;
  for (size_t i = 0; i < kept.size(); ++i)
    PyList_SET_ITEM(out, i, PyLong_FromSsize_t(kept[i]));
  return out;
}

// ap_detection(preds: (N,3) float64 [st, ed, score], gts: (M,2) float64,
//              thds: (T,) float64 as (T,1) 2-D) -> list[float] AP per thd.
// preds need not be pre-sorted.
PyObject* ap_detection(PyObject*, PyObject* args) {
  PyObject *preds_o, *gts_o, *thds_o;
  if (!PyArg_ParseTuple(args, "OOO", &preds_o, &gts_o, &thds_o)) return nullptr;
  BufferGuard gp, gg, gt;
  if (!get_2d(preds_o, gp, 3, "preds")) return nullptr;
  if (!get_2d(gts_o, gg, 2, "gts")) return nullptr;
  if (!get_2d(thds_o, gt, 1, "thds")) return nullptr;
  const double* preds = static_cast<const double*>(gp.view.buf);
  const double* gts = static_cast<const double*>(gg.view.buf);
  const double* thds = static_cast<const double*>(gt.view.buf);
  const Py_ssize_t n = gp.view.shape[0];
  const Py_ssize_t m = gg.view.shape[0];
  const Py_ssize_t t = gt.view.shape[0];

  PyObject* out = PyList_New(t);
  if (!out) return nullptr;
  if (n == 0 || m == 0) {
    for (Py_ssize_t i = 0; i < t; ++i)
      PyList_SET_ITEM(out, i, PyFloat_FromDouble(0.0));
    return out;
  }

  std::vector<Py_ssize_t> order(n);
  for (Py_ssize_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](Py_ssize_t a, Py_ssize_t b) {
    return preds[a * 3 + 2] > preds[b * 3 + 2];
  });

  std::vector<double> iou(m);
  std::vector<Py_ssize_t> gt_order(m);
  std::vector<char> locked(t * m);
  std::vector<double> tp(n), fp(n);
  std::vector<double> ap(t, 0.0);

  for (Py_ssize_t ti = 0; ti < t; ++ti) {
    const double thr = thds[ti];
    std::fill(tp.begin(), tp.end(), 0.0);
    std::fill(fp.begin(), fp.end(), 0.0);
    char* lock = locked.data() + ti * m;
    std::fill(lock, lock + m, 0);
    for (Py_ssize_t pi = 0; pi < n; ++pi) {
      const double* p = preds + order[pi] * 3;
      for (Py_ssize_t j = 0; j < m; ++j) {
        iou[j] = true_iou(p, gts + j * 2);
        gt_order[j] = j;
      }
      // ties break toward the larger index, matching the reference's
      // argsort()[::-1] (eval.py:384)
      std::stable_sort(gt_order.begin(), gt_order.end(),
                       [&](Py_ssize_t a, Py_ssize_t b) {
                         return iou[a] > iou[b] || (iou[a] == iou[b] && a > b);
                       });
      bool assigned = false;
      for (Py_ssize_t jo = 0; jo < m; ++jo) {
        const Py_ssize_t j = gt_order[jo];
        if (iou[j] < thr) {
          fp[pi] = 1.0;
          assigned = true;
          break;
        }
        if (lock[j]) continue;
        tp[pi] = 1.0;
        lock[j] = 1;
        assigned = true;
        break;
      }
      if (!assigned) fp[pi] = 1.0;
    }
    // cumulative precision/recall + VOC interpolation
    std::vector<double> prec(n), rec(n);
    double ctp = 0.0, cfp = 0.0;
    for (Py_ssize_t i = 0; i < n; ++i) {
      ctp += tp[i];
      cfp += fp[i];
      rec[i] = ctp / (double)m;
      prec[i] = ctp / (ctp + cfp);
    }
    std::vector<double> mprec(n + 2), mrec(n + 2);
    mprec[0] = 0.0;
    mrec[0] = 0.0;
    for (Py_ssize_t i = 0; i < n; ++i) {
      mprec[i + 1] = prec[i];
      mrec[i + 1] = rec[i];
    }
    mprec[n + 1] = 0.0;
    mrec[n + 1] = 1.0;
    for (Py_ssize_t i = n; i >= 0; --i)
      mprec[i] = std::max(mprec[i], mprec[i + 1]);
    double a = 0.0;
    for (Py_ssize_t i = 1; i < n + 2; ++i)
      if (mrec[i] != mrec[i - 1]) a += (mrec[i] - mrec[i - 1]) * mprec[i];
    ap[ti] = a;
  }

  for (Py_ssize_t i = 0; i < t; ++i)
    PyList_SET_ITEM(out, i, PyFloat_FromDouble(ap[i]));
  return out;
}

// mean_pool(feat: (L,D) float32 C-contiguous, max_len) -> bytes of
// (max_len, D) float32, reference dataset/base.py:100-114 semantics.
PyObject* mean_pool(PyObject*, PyObject* args) {
  PyObject* arr;
  Py_ssize_t max_len;
  if (!PyArg_ParseTuple(args, "On", &arr, &max_len)) return nullptr;
  BufferGuard g;
  if (PyObject_GetBuffer(arr, &g.view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0)
    return nullptr;
  g.ok = true;
  if (g.view.ndim != 2 || std::strcmp(g.view.format ? g.view.format : "", "f") != 0) {
    PyErr_SetString(PyExc_ValueError, "feat must be C-contiguous float32 (L, D)");
    return nullptr;
  }
  const float* feat = static_cast<const float*>(g.view.buf);
  const Py_ssize_t L = g.view.shape[0];
  const Py_ssize_t D = g.view.shape[1];
  if (L <= max_len) {
    PyErr_SetString(PyExc_ValueError, "mean_pool requires L > max_len");
    return nullptr;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, max_len * D * sizeof(float));
  if (!out) return nullptr;
  float* o = reinterpret_cast<float*>(PyBytes_AS_STRING(out));
  for (Py_ssize_t i = 0; i < max_len; ++i) {
    // idx = round(i / max_len * L) clamped, matching numpy round-half-even
    auto edge = [&](Py_ssize_t j) {
      double x = (double)j / (double)max_len * (double)L;
      double r = std::nearbyint(x);  // round-half-even in default FE mode
      if (r > (double)(L - 1)) r = (double)(L - 1);
      return (Py_ssize_t)r;
    };
    const Py_ssize_t s = edge(i), e = edge(i + 1);
    float* dst = o + i * D;
    if (s < e) {
      for (Py_ssize_t d = 0; d < D; ++d) dst[d] = 0.0f;
      for (Py_ssize_t r = s; r < e; ++r) {
        const float* src = feat + r * D;
        for (Py_ssize_t d = 0; d < D; ++d) dst[d] += src[d];
      }
      const float inv = 1.0f / (float)(e - s);
      for (Py_ssize_t d = 0; d < D; ++d) dst[d] *= inv;
    } else {
      std::memcpy(dst, feat + s * D, D * sizeof(float));
    }
  }
  return out;
}

PyMethodDef methods[] = {
    {"temporal_nms", temporal_nms, METH_VARARGS,
     "greedy temporal NMS -> kept indices"},
    {"ap_detection", ap_detection, METH_VARARGS,
     "VOC-interpolated AP per IoU threshold"},
    {"mean_pool", mean_pool, METH_VARARGS,
     "mean-pool downsample (L,D)->(max_len,D) float32 bytes"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_mesm_native", nullptr, -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__mesm_native() { return PyModule_Create(&moduledef); }
