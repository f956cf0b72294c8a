// quinoa_tpu native host kernels.
//
// The reference implements its host/runtime layer in C++ (Charm++ chares,
// Zoltan partitioning, DerivedData connectivity generators); this build
// keeps the compute path in XLA but implements the per-(re)partition host
// kernels natively too: derived connectivity (the analog of
// src/Mesh/DerivedData.hpp genEsuel/genEsup), the assembly gather-table
// builder, and Morton codes for the space-filling-curve partitioner (the
// Zoltan2 HSFC analog, src/LoadBalance/ZoltanInterOp.cpp).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Elements surrounding elements across faces: esuel[e*4+f] = neighbor or -1.
// Face f of a tet is opposite local node f (lpofa convention of
// src/Mesh/DerivedData.hpp).
//
// Face keys are the three sorted node ids held in full width (no bit
// packing), so the map is collision-free for any node count.
struct QnFaceKey {
  int32_t n[3];
  bool operator==(const QnFaceKey& o) const {
    return n[0] == o.n[0] && n[1] == o.n[1] && n[2] == o.n[2];
  }
};
struct QnFaceKeyHash {
  size_t operator()(const QnFaceKey& k) const {
    // splitmix64-style mix of the three ids
    uint64_t x = (static_cast<uint64_t>(static_cast<uint32_t>(k.n[0])) << 32) ^
                 (static_cast<uint64_t>(static_cast<uint32_t>(k.n[1])) << 16) ^
                 static_cast<uint64_t>(static_cast<uint32_t>(k.n[2]));
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return static_cast<size_t>(x ^ (x >> 31));
  }
};

void qn_gen_esuel(int64_t nelem, const int32_t* inpoel, int32_t* esuel) {
  static const int F[4][3] = {{1, 2, 3}, {0, 3, 2}, {0, 1, 3}, {0, 2, 1}};
  std::unordered_map<QnFaceKey, int64_t, QnFaceKeyHash> open;
  open.reserve(static_cast<size_t>(nelem) * 2);
  std::fill(esuel, esuel + nelem * 4, -1);

  auto key = [](int32_t a, int32_t b, int32_t c) -> QnFaceKey {
    if (a > b) std::swap(a, b);
    if (b > c) std::swap(b, c);
    if (a > b) std::swap(a, b);
    return QnFaceKey{{a, b, c}};
  };

  for (int64_t e = 0; e < nelem; ++e) {
    const int32_t* n = inpoel + e * 4;
    for (int f = 0; f < 4; ++f) {
      QnFaceKey k = key(n[F[f][0]], n[F[f][1]], n[F[f][2]]);
      auto it = open.find(k);
      if (it == open.end()) {
        open.emplace(k, e * 4 + f);
      } else {
        int64_t of = it->second;
        esuel[e * 4 + f] = static_cast<int32_t>(of / 4);
        esuel[of] = static_cast<int32_t>(e);
        open.erase(it);
      }
    }
  }
}

// Max slots per node for the assembly gather table (returns D).
int64_t qn_nsup_degree(int64_t nent, int64_t width, int64_t nnode,
                       const int32_t* incid) {
  std::vector<int32_t> cnt(nnode, 0);
  for (int64_t i = 0; i < nent * width; ++i) cnt[incid[i]]++;
  int32_t d = 0;
  for (int64_t p = 0; p < nnode; ++p) d = std::max(d, cnt[p]);
  return d;
}

// Fill the (D, nnode) gather table with flattened slot ids a*nent + e
// (pad = width*nent), matching ops.assembly.build_nsup.
void qn_build_nsup(int64_t nent, int64_t width, int64_t nnode,
                   const int32_t* incid, int64_t D, int32_t* nsup) {
  const int32_t pad = static_cast<int32_t>(width * nent);
  std::fill(nsup, nsup + D * nnode, pad);
  std::vector<int32_t> fill(nnode, 0);
  // slot id = a*nent + e for incid[e*width + a] — iterate a-major to match
  // the numpy (stable, slot-ordered) fill
  for (int64_t a = 0; a < width; ++a) {
    for (int64_t e = 0; e < nent; ++e) {
      int32_t p = incid[e * width + a];
      nsup[static_cast<int64_t>(fill[p]) * nnode + p] =
          static_cast<int32_t>(a * nent + e);
      fill[p]++;
    }
  }
}

// Fused tetrahedral geometry: Jacobians + P1 shape-function gradients in
// one pass (the analog of tk::crossdiv element loops,
// src/Base/Vector.hpp:21-37 / src/PDE/CompFlow/CGCompFlow.hpp:191-348).
// Single traversal in f64 — NumPy needs ~10 full-array passes for the
// same math and is ~25x slower on the AMR-rebuild hot path.
// Same operation order as mesh/geometry.py:tet_geometry (a*b-c*d crosses,
// then divide by J) so results agree to the default-FP-contraction ulp.
void qn_tet_geometry(int64_t nelem, const double* coords,
                     const int32_t* inpoel, double* J, double* grad) {
  for (int64_t e = 0; e < nelem; ++e) {
    const int32_t* n = inpoel + e * 4;
    const double* A = coords + static_cast<int64_t>(n[0]) * 3;
    const double* B = coords + static_cast<int64_t>(n[1]) * 3;
    const double* C = coords + static_cast<int64_t>(n[2]) * 3;
    const double* D = coords + static_cast<int64_t>(n[3]) * 3;
    double ba[3], ca[3], da[3];
    for (int d = 0; d < 3; ++d) {
      ba[d] = B[d] - A[d];
      ca[d] = C[d] - A[d];
      da[d] = D[d] - A[d];
    }
    auto cross = [](const double* u, const double* v, double* o) {
      o[0] = u[1] * v[2] - u[2] * v[1];
      o[1] = u[2] * v[0] - u[0] * v[2];
      o[2] = u[0] * v[1] - u[1] * v[0];
    };
    double baca[3], cada[3], daba[3];
    cross(ba, ca, baca);
    cross(ca, da, cada);
    cross(da, ba, daba);
    double j = baca[0] * da[0] + baca[1] * da[1] + baca[2] * da[2];
    J[e] = j;
    double* g = grad + e * 12;
    for (int d = 0; d < 3; ++d) {
      g[3 + d] = cada[d] / j;   // grad[e,1]
      g[6 + d] = daba[d] / j;   // grad[e,2]
      g[9 + d] = baca[d] / j;   // grad[e,3]
      g[d] = -(g[3 + d] + g[6 + d] + g[9 + d]);
    }
  }
}

// Unique undirected edges of a tet mesh: sorted (lo,hi) pairs in
// lexicographic order (genInpoed, src/Mesh/DerivedData.hpp).  Writes at
// most nelem*6 pairs into `edges` (caller allocates) and returns the
// unique count.  One u64-key sort instead of NumPy's void-view
// np.unique(axis=0), ~50x faster at AMR-rebuild sizes.
int64_t qn_unique_edges(int64_t nelem, const int32_t* inpoel,
                        int32_t* edges) {
  static const int E[6][2] = {{0, 1}, {1, 2}, {2, 0},
                              {0, 3}, {1, 3}, {2, 3}};
  std::vector<uint64_t> keys(static_cast<size_t>(nelem) * 6);
  for (int64_t e = 0; e < nelem; ++e) {
    const int32_t* n = inpoel + e * 4;
    for (int k = 0; k < 6; ++k) {
      uint32_t a = static_cast<uint32_t>(n[E[k][0]]);
      uint32_t b = static_cast<uint32_t>(n[E[k][1]]);
      if (a > b) std::swap(a, b);
      keys[e * 6 + k] = (static_cast<uint64_t>(a) << 32) | b;
    }
  }
  std::sort(keys.begin(), keys.end());
  int64_t m = 0;
  for (size_t i = 0; i < keys.size(); ++i) {
    if (i == 0 || keys[i] != keys[i - 1]) {
      edges[m * 2] = static_cast<int32_t>(keys[i] >> 32);
      edges[m * 2 + 1] = static_cast<int32_t>(keys[i] & 0xFFFFFFFFu);
      ++m;
    }
  }
  return m;
}

// Element-node coordinate cache: coords (N,3) + inpoel (E,4) ->
// cn (4,3,E) and element centers ctr (3,E), written in target layout in
// one pass (coords_cache_np otherwise pays a (4,E,3) gather + transpose
// + contiguous copy, the largest remaining AMR-rebuild cost).
void qn_coords_cache(int64_t nelem, const double* coords,
                     const int32_t* inpoel, double* cn, double* ctr) {
  for (int64_t e = 0; e < nelem; ++e) {
    const int32_t* n = inpoel + e * 4;
    double p[4][3];
    for (int a = 0; a < 4; ++a) {
      const double* c = coords + static_cast<int64_t>(n[a]) * 3;
      for (int d = 0; d < 3; ++d) {
        p[a][d] = c[d];
        cn[(static_cast<int64_t>(a) * 3 + d) * nelem + e] = c[d];
      }
    }
    // sequential sum then divide — np.mean over axis 0 reduces
    // strided 4-element columns sequentially (pairwise summation only
    // applies to contiguous 1-D reductions), so this is bit-identical
    // to the NumPy fallback's cn.mean(axis=0)
    for (int d = 0; d < 3; ++d)
      ctr[static_cast<int64_t>(d) * nelem + e] =
          (((p[0][d] + p[1][d]) + p[2][d]) + p[3][d]) / 4.0;
  }
}

// Nodal dual volumes: v_p = sum_e J_e/24 over elements containing p
// (Discretization::vol, src/Inciter/Discretization.cpp).
void qn_nodal_volumes(int64_t nelem, int64_t nnode, const double* J,
                      const int32_t* inpoel, double* vol) {
  std::fill(vol, vol + nnode, 0.0);
  for (int64_t e = 0; e < nelem; ++e) {
    const double w = J[e] / 24.0;
    const int32_t* n = inpoel + e * 4;
    for (int a = 0; a < 4; ++a) vol[n[a]] += w;
  }
}

// Faces-of-element table with L/R side flags: the sequential slot-fill
// over el-sorted faces (build_dggeom's contract: slots in face order,
// L entry first when a face is both sides of the same element pair).
// A 1.4M-iteration Python loop otherwise.  Returns the number of
// elements that did NOT fill exactly 4 slots (slot overflow from a
// malformed mesh is counted, never written past the (4, nelem) table).
int64_t qn_build_fose(int64_t nface, int64_t nelem, const int64_t* el,
                      const int64_t* er, int32_t* fose, double* fsideR) {
  std::vector<int32_t> slot(nelem, 0);
  std::fill(fose, fose + 4 * nelem, 0);
  std::fill(fsideR, fsideR + 4 * nelem, 0.0);
  for (int64_t f = 0; f < nface; ++f) {
    int64_t e = el[f];
    if (slot[e] < 4) {
      fose[static_cast<int64_t>(slot[e]) * nelem + e] =
          static_cast<int32_t>(f);
    }
    slot[e]++;
    if (er[f] != e) {
      int64_t e2 = er[f];
      if (slot[e2] < 4) {
        fose[static_cast<int64_t>(slot[e2]) * nelem + e2] =
            static_cast<int32_t>(f);
        fsideR[static_cast<int64_t>(slot[e2]) * nelem + e2] = 1.0;
      }
      slot[e2]++;
    }
  }
  int64_t bad = 0;
  for (int64_t e = 0; e < nelem; ++e)
    if (slot[e] != 4) ++bad;
  return bad;
}

// Per-shard variant: only OWNED elements (< nown) get slots, and ghost
// R sides of boundary-coded faces are skipped (build_dg_shards'
// contract for stacked shard tables).
// Returns the number of owned elements that did NOT fill exactly 4
// slots (0 on a conforming shard; the caller asserts).
int64_t qn_build_fose_masked(int64_t nface, int64_t nelem, int64_t nown,
                             const int64_t* el, const int64_t* er,
                             const int32_t* bctype, int32_t* fose,
                             double* fsideR) {
  std::vector<int32_t> slot(nelem, 0);
  for (int64_t f = 0; f < nface; ++f) {
    int64_t e = el[f];
    if (e < nown) {
      if (slot[e] < 4) {
        fose[static_cast<int64_t>(slot[e]) * nelem + e] =
            static_cast<int32_t>(f);
        fsideR[static_cast<int64_t>(slot[e]) * nelem + e] = 0.0;
      }
      slot[e]++;
    }
    int64_t e2 = er[f];
    if (e2 < nown && e2 != e && bctype[f] == 0) {
      if (slot[e2] < 4) {
        fose[static_cast<int64_t>(slot[e2]) * nelem + e2] =
            static_cast<int32_t>(f);
        fsideR[static_cast<int64_t>(slot[e2]) * nelem + e2] = 1.0;
      }
      slot[e2]++;
    }
  }
  int64_t bad = 0;
  for (int64_t e = 0; e < nown; ++e)
    if (slot[e] != 4) ++bad;
  return bad;
}

// Reference coordinates of face Gauss points in the left/right element:
// xi = jacInv[e] . (gp - n0[e]) with gp = sum_i shp[g,i] * coords[face
// node i] — fused, replacing two gathered (F,G,3) einsums.
void qn_face_xi(int64_t nface, int64_t ng, const double* coords,
                const int32_t* inpofa, const double* shp,
                const double* jacInv, const double* n0,
                const int64_t* el, const int64_t* er,
                double* xi_l, double* xi_r) {
  for (int64_t f = 0; f < nface; ++f) {
    const int32_t* fa = inpofa + f * 3;
    const double* p0 = coords + static_cast<int64_t>(fa[0]) * 3;
    const double* p1 = coords + static_cast<int64_t>(fa[1]) * 3;
    const double* p2 = coords + static_cast<int64_t>(fa[2]) * 3;
    const double* Jl = jacInv + el[f] * 9;
    const double* Jr = jacInv + er[f] * 9;
    const double* al = n0 + el[f] * 3;
    const double* ar = n0 + er[f] * 3;
    for (int64_t g = 0; g < ng; ++g) {
      const double* s = shp + g * 3;
      double gp[3];
      for (int d = 0; d < 3; ++d)
        gp[d] = s[0] * p0[d] + s[1] * p1[d] + s[2] * p2[d];
      double dl[3], dr[3];
      for (int d = 0; d < 3; ++d) {
        dl[d] = gp[d] - al[d];
        dr[d] = gp[d] - ar[d];
      }
      double* ol = xi_l + (f * ng + g) * 3;
      double* orr = xi_r + (f * ng + g) * 3;
      for (int i = 0; i < 3; ++i) {
        ol[i] = Jl[i * 3] * dl[0] + Jl[i * 3 + 1] * dl[1] +
                Jl[i * 3 + 2] * dl[2];
        orr[i] = Jr[i * 3] * dr[0] + Jr[i * 3 + 1] * dr[1] +
                 Jr[i * 3 + 2] * dr[2];
      }
    }
  }
}

// Hilbert-curve indices of 3-D points (Skilling's transpose algorithm;
// identical quantization and bit order to mesh/reorder.py:
// hilbert_codes, which needs ~100 full-array NumPy passes).
void qn_hilbert_codes(int64_t n, const double* pts, int32_t bits,
                      uint64_t* codes) {
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], pts[i * 3 + d]);
      hi[d] = std::max(hi[d], pts[i * 3 + d]);
    }
  double span[3];
  for (int d = 0; d < 3; ++d) {
    span[d] = hi[d] - lo[d];
    if (span[d] == 0.0) span[d] = 1.0;
  }
  const double s = static_cast<double>((1u << bits) - 1);
  const uint32_t M = 1u << (bits - 1);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t X[3];
    for (int d = 0; d < 3; ++d)
      X[d] = static_cast<uint32_t>((pts[i * 3 + d] - lo[d]) / span[d] * s);
    for (uint32_t Q = M; Q > 1; Q >>= 1) {  // inverse undo excess work
      uint32_t P = Q - 1;
      for (int d = 0; d < 3; ++d) {
        if (X[d] & Q) {
          X[0] ^= P;
        } else {
          uint32_t t = (X[0] ^ X[d]) & P;
          X[0] ^= t;
          X[d] ^= t;
        }
      }
    }
    for (int d = 1; d < 3; ++d) X[d] ^= X[d - 1];  // Gray encode
    uint32_t t = 0;
    for (uint32_t Q = M; Q > 1; Q >>= 1)
      if (X[2] & Q) t ^= Q - 1;
    for (int d = 0; d < 3; ++d) X[d] ^= t;
    uint64_t h = 0;  // interleave transpose bits, X[0] carries the MSB
    for (int b = bits - 1; b >= 0; --b)
      for (int d = 0; d < 3; ++d)
        h = (h << 1) | ((X[d] >> b) & 1u);
    codes[i] = h;
  }
}

// Morton codes over quantized 3-D points (21 bits per axis).
void qn_morton_codes(int64_t n, const double* pts, uint64_t* codes) {
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], pts[i * 3 + d]);
      hi[d] = std::max(hi[d], pts[i * 3 + d]);
    }
  double span[3];
  for (int d = 0; d < 3; ++d) {
    span[d] = hi[d] - lo[d];
    if (span[d] == 0.0) span[d] = 1.0;
  }
  auto spread = [](uint64_t x) {
    x &= 0x1FFFFF;
    x = (x | (x << 32)) & 0x1F00000000FFFFULL;
    x = (x | (x << 16)) & 0x1F0000FF0000FFULL;
    x = (x | (x << 8)) & 0x100F00F00F00F00FULL;
    x = (x | (x << 4)) & 0x10C30C30C30C30C3ULL;
    x = (x | (x << 2)) & 0x1249249249249249ULL;
    return x;
  };
  const double s = (1 << 21) - 1;
  for (int64_t i = 0; i < n; ++i) {
    uint64_t q[3];
    for (int d = 0; d < 3; ++d)
      q[d] = static_cast<uint64_t>((pts[i * 3 + d] - lo[d]) / span[d] * s);
    codes[i] = spread(q[0]) | (spread(q[1]) << 1) | (spread(q[2]) << 2);
  }
}

// ---------------------------------------------------------------------------
// RNGTest compression/complexity kernels (the scomp_ family of the
// reference's TestU01 batteries, src/RNGTest/Crush.cpp:747,765).  Both
// are inherently sequential bit-stream algorithms — the one part of the
// battery that cannot be a vectorized reduction — so they live here.

// LZ78 phrase count: parse the bit stream (packed MSB-first in bytes)
// into the incremental dictionary; return the number of phrases
// (counting a trailing incomplete phrase, consistently with the
// calibrated null law in rngtest/battery.py).  Trie children are a flat
// 2-ary array indexed by node id.
int64_t qn_lz78_phrases(const uint8_t* bytes, int64_t nbits) {
  std::vector<int32_t> child;
  child.reserve(1 << 20);
  child.push_back(-1);  // root, bit 0
  child.push_back(-1);  // root, bit 1
  int64_t phrases = 0;
  int32_t cur = 0;
  bool in_phrase = false;
  for (int64_t i = 0; i < nbits; ++i) {
    const int bit = (bytes[i >> 3] >> (7 - (i & 7))) & 1;
    const int64_t slot = static_cast<int64_t>(cur) * 2 + bit;
    const int32_t nxt = child[slot];
    if (nxt >= 0) {
      cur = nxt;
      in_phrase = true;
    } else {
      // new phrase: add a node, restart at the root
      const int32_t id = static_cast<int32_t>(child.size() / 2);
      child[slot] = id;
      child.push_back(-1);
      child.push_back(-1);
      ++phrases;
      cur = 0;
      in_phrase = false;
    }
  }
  return phrases + (in_phrase ? 1 : 0);
}

// Berlekamp-Massey over GF(2) with bitset arithmetic: synthesize the
// shortest LFSR for the bit stream (packed MSB-first in bytes), record
// the SIZE of every jump in the linear complexity profile into
// jump_sizes (up to cap), and return the jump count (final complexity
// via *final_L).  The discrepancy at step t is the parity of the AND
// between the connection polynomial C (bit i = c_i) and the reversed
// sequence window starting at bit ntot-1-t, evaluated word-wise.
int64_t qn_berlekamp_massey(const uint8_t* bytes, int64_t nbits,
                            int32_t* jump_sizes, int64_t cap,
                            int64_t* final_L) {
  const int64_t nw = (nbits + 64) / 64 + 2;
  std::vector<uint64_t> srev(nw, 0), C(nw, 0), B(nw, 0), T(nw, 0);
  for (int64_t i = 0; i < nbits; ++i) {
    const int bit = (bytes[i >> 3] >> (7 - (i & 7))) & 1;
    const int64_t j = nbits - 1 - i;  // reversed index
    if (bit) srev[j >> 6] |= (1ULL << (j & 63));
  }
  auto window64 = [&](int64_t p) -> uint64_t {
    const int64_t w = p >> 6, b = p & 63;
    uint64_t x = srev[w] >> b;
    if (b) x |= srev[w + 1] << (64 - b);
    return x;
  };
  C[0] = 1;
  B[0] = 1;
  int64_t L = 0, m = -1, njumps = 0;
  int64_t bwords = 1;  // words holding B's nonzero coefficients
  for (int64_t t = 0; t < nbits; ++t) {
    // d = parity( sum_{i=0..L} c_i * s_{t-i} ); C is zero above bit L
    const int64_t o = nbits - 1 - t;
    const int64_t wmax = (L >> 6) + 1;
    uint64_t acc = 0;
    for (int64_t w = 0; w < wmax; ++w) acc ^= C[w] & window64(o + 64 * w);
    if (!__builtin_parityll(acc)) continue;
    const int64_t shift = t - m;
    const int64_t ws = shift >> 6, bs = shift & 63;
    const bool jump = 2 * L <= t;
    if (jump) {
      // T <- old C (degree <= L), zero-padded over B's old extent
      const int64_t cw = (L >> 6) + 1;
      std::copy(C.begin(), C.begin() + cw, T.begin());
      if (bwords > cw) std::fill(T.begin() + cw, T.begin() + bwords, 0);
    }
    // C ^= B << shift  (B's degree <= L, so <= bwords words)
    for (int64_t w = bwords - 1; w >= 0; --w) {
      uint64_t v = B[w] << bs;
      if (bs && w) v |= B[w - 1] >> (64 - bs);
      if (w + ws < nw) C[w + ws] ^= v;
    }
    if (jump) {
      const int64_t newL = t + 1 - L;
      if (njumps < cap) jump_sizes[njumps] = static_cast<int32_t>(newL - L);
      ++njumps;
      std::swap(B, T);
      bwords = (L >> 6) + 1;  // B's degree = old L
      m = t;
      L = newL;
    }
  }
  *final_L = L;
  return njumps;
}

}  // extern "C"
