// RLE mask operations — C++ implementation of the COCO mask API surface.
//
// Reference parity: coco/common/maskApi.{h,c} (C, ~290 LoC) exposed to Python
// through a Cython bridge (coco/PythonAPI/pycocotools/_mask.pyx). This is a
// clean-room C++ implementation of the same capability surface: RLE
// encode/decode/merge/area/IoU/NMS/toBbox/frBbox/frPoly and the LEB128-style
// string codec, bound to Python via ctypes (adaptive_tpu/native/mask.py) —
// no pybind11 needed.
//
// Conventions match the COCO API: masks are column-major (Fortran order)
// h x w uint8 arrays; an RLE alternates run lengths of 0s and 1s starting
// with 0s.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

struct RLE {
  uint64_t h, w, m;   // mask size, number of runs
  uint32_t* cnts;     // run lengths (malloc'd)
};

static RLE* rle_alloc(uint64_t h, uint64_t w, uint64_t m) {
  RLE* r = new RLE();
  r->h = h; r->w = w; r->m = m;
  r->cnts = m ? new uint32_t[m]() : nullptr;
  return r;
}

void rleFree(RLE* r) {
  if (!r) return;
  delete[] r->cnts;
  delete r;
}

// ---------------------------------------------------------------- encode
RLE* rleEncode(const uint8_t* mask, uint64_t h, uint64_t w) {
  // column-major scan; runs alternate starting with zeros
  std::vector<uint32_t> cnts;
  uint64_t n = h * w;
  uint8_t prev = 0;
  uint32_t run = 0;
  for (uint64_t i = 0; i < n; ++i) {
    uint8_t v = mask[i] ? 1 : 0;
    if (v != prev) {
      cnts.push_back(run);
      run = 0;
      prev = v;
    }
    ++run;
  }
  cnts.push_back(run);
  RLE* r = rle_alloc(h, w, cnts.size());
  std::copy(cnts.begin(), cnts.end(), r->cnts);
  return r;
}

// ---------------------------------------------------------------- decode
// Bounded by the DESTINATION capacity `cap`, not the RLE's own claimed h*w:
// a corrupt/crafted counts string (e.g. from a results JSON) whose runs sum
// past the buffer the caller allocated must not overflow it — and callers
// size buffers from rs[0], not from each RLE. The reference's maskApi.c
// trusts the counts (maskApi.c:14-22); well-formed RLEs behave identically.
void rleDecodeBounded(const RLE* r, uint8_t* mask, uint64_t cap) {
  uint64_t pos = 0;
  uint8_t v = 0;
  for (uint64_t j = 0; j < r->m && pos < cap; ++j) {
    uint32_t run = r->cnts[j];
    for (uint32_t k = 0; k < run && pos < cap; ++k) mask[pos++] = v;
    v = 1 - v;
  }
}

void rleDecode(const RLE* r, uint8_t* mask) {
  rleDecodeBounded(r, mask, r->h * r->w);
}

// ---------------------------------------------------------------- area
uint64_t rleArea(const RLE* r) {
  uint64_t a = 0;
  for (uint64_t j = 1; j < r->m; j += 2) a += r->cnts[j];
  return a;
}

// ---------------------------------------------------------------- merge
// intersect==0 -> union, intersect==1 -> intersection
RLE* rleMerge(const RLE** rs, uint64_t n, int intersect) {
  if (n == 0) return rle_alloc(0, 0, 0);
  uint64_t h = rs[0]->h, w = rs[0]->w;
  // simple + robust: decode, combine, re-encode (sizes are small in COCO)
  std::vector<uint8_t> acc(h * w);
  rleDecodeBounded(rs[0], acc.data(), h * w);
  std::vector<uint8_t> tmp(h * w);
  for (uint64_t i = 1; i < n; ++i) {
    std::fill(tmp.begin(), tmp.end(), 0);  // rs[i] may claim a smaller size
    rleDecodeBounded(rs[i], tmp.data(), h * w);
    for (uint64_t k = 0; k < h * w; ++k)
      acc[k] = intersect ? (acc[k] & tmp[k]) : (acc[k] | tmp[k]);
  }
  return rleEncode(acc.data(), h, w);
}

// ---------------------------------------------------------------- bbox
void rleToBbox(const RLE* r, double* bb) {
  // returns [x, y, w, h]
  uint64_t h = r->h;
  uint64_t xs = r->w, xe = 0, ys = r->h, ye = 0;
  bool any = false;
  uint64_t pos = 0;
  uint8_t v = 0;
  for (uint64_t j = 0; j < r->m; ++j) {
    if (v) {
      uint64_t start = pos, end = pos + r->cnts[j] - 1;
      uint64_t x0 = start / h, y0 = start % h, x1 = end / h, y1 = end % h;
      any = true;
      xs = std::min(xs, x0); xe = std::max(xe, x1);
      if (x0 == x1) { ys = std::min(ys, y0); ye = std::max(ye, y1); }
      else { ys = 0; ye = h - 1; }
    }
    pos += r->cnts[j];
    v = 1 - v;
  }
  if (!any) { bb[0] = bb[1] = bb[2] = bb[3] = 0; return; }
  bb[0] = (double)xs; bb[1] = (double)ys;
  bb[2] = (double)(xe - xs + 1); bb[3] = (double)(ye - ys + 1);
}

// ---------------------------------------------------------------- iou
double rleIouOne(const RLE* a, const RLE* b, int iscrowd) {
  const RLE* pair_u[2] = {a, b};
  RLE* inter = rleMerge(pair_u, 2, 1);
  double ai = (double)rleArea(inter);
  rleFree(inter);
  double aa = (double)rleArea(a), ab = (double)rleArea(b);
  double u = iscrowd ? aa : (aa + ab - ai);
  return u > 0 ? ai / u : 0.0;
}

void rleIou(const RLE** dt, uint64_t m, const RLE** gt, uint64_t n,
            const uint8_t* iscrowd, double* out) {
  for (uint64_t i = 0; i < m; ++i)
    for (uint64_t j = 0; j < n; ++j)
      out[i * n + j] = rleIouOne(dt[i], gt[j], iscrowd ? iscrowd[j] : 0);
}

void bbIou(const double* dt, uint64_t m, const double* gt, uint64_t n,
           const uint8_t* iscrowd, double* out) {
  for (uint64_t i = 0; i < m; ++i) {
    double dx = dt[i * 4], dy = dt[i * 4 + 1], dw = dt[i * 4 + 2], dh = dt[i * 4 + 3];
    double da = dw * dh;
    for (uint64_t j = 0; j < n; ++j) {
      double gx = gt[j * 4], gy = gt[j * 4 + 1], gw = gt[j * 4 + 2], gh = gt[j * 4 + 3];
      double ga = gw * gh;
      double iw = std::min(dx + dw, gx + gw) - std::max(dx, gx);
      double ih = std::min(dy + dh, gy + gh) - std::max(dy, gy);
      double inter = (iw > 0 && ih > 0) ? iw * ih : 0.0;
      double u = iscrowd && iscrowd[j] ? da : (da + ga - inter);
      out[i * n + j] = u > 0 ? inter / u : 0.0;
    }
  }
}

// ---------------------------------------------------------------- nms
void rleNms(RLE** dt, uint64_t n, uint8_t* keep, double thr) {
  for (uint64_t i = 0; i < n; ++i) keep[i] = 1;
  for (uint64_t i = 0; i < n; ++i) {
    if (!keep[i]) continue;
    for (uint64_t j = i + 1; j < n; ++j) {
      if (!keep[j]) continue;
      if (rleIouOne(dt[i], dt[j], 0) > thr) keep[j] = 0;
    }
  }
}

// ---------------------------------------------------------------- frBbox
RLE* rleFrBbox(const double* bb, uint64_t h, uint64_t w) {
  std::vector<uint8_t> mask(h * w, 0);
  uint64_t xs = (uint64_t)std::max(0.0, std::floor(bb[0]));
  uint64_t ys = (uint64_t)std::max(0.0, std::floor(bb[1]));
  uint64_t xe = (uint64_t)std::min((double)w, std::ceil(bb[0] + bb[2]));
  uint64_t ye = (uint64_t)std::min((double)h, std::ceil(bb[1] + bb[3]));
  for (uint64_t x = xs; x < xe; ++x)
    for (uint64_t y = ys; y < ye; ++y)
      mask[x * h + y] = 1;
  return rleEncode(mask.data(), h, w);
}

// ---------------------------------------------------------------- frPoly
// scanline polygon rasterization (even-odd), matching the COCO convention of
// upscaling by 5 for sub-pixel accuracy then downsampling.
RLE* rleFrPoly(const double* xy, uint64_t k, uint64_t h, uint64_t w) {
  const int S = 5;
  uint64_t hs = h * S, ws = w * S;
  std::vector<double> xs(k), ys(k);
  for (uint64_t i = 0; i < k; ++i) {
    xs[i] = xy[2 * i] * S;
    ys[i] = xy[2 * i + 1] * S;
  }
  std::vector<uint8_t> up(hs * ws, 0);
  // even-odd scanline fill per upscaled row
  for (uint64_t row = 0; row < hs; ++row) {
    double yc = row + 0.5;
    std::vector<double> xcross;
    for (uint64_t i = 0; i < k; ++i) {
      uint64_t j = (i + 1) % k;
      double y0 = ys[i], y1 = ys[j], x0 = xs[i], x1 = xs[j];
      if ((y0 <= yc && y1 > yc) || (y1 <= yc && y0 > yc)) {
        double t = (yc - y0) / (y1 - y0);
        xcross.push_back(x0 + t * (x1 - x0));
      }
    }
    std::sort(xcross.begin(), xcross.end());
    for (size_t c = 0; c + 1 < xcross.size(); c += 2) {
      int64_t a = (int64_t)std::ceil(xcross[c] - 0.5);
      int64_t b = (int64_t)std::floor(xcross[c + 1] - 0.5);
      for (int64_t x = std::max<int64_t>(a, 0); x <= std::min<int64_t>(b, (int64_t)ws - 1); ++x)
        up[(uint64_t)x * hs + row] = 1;
    }
  }
  // downsample: pixel on if any subpixel on (COCO uses this convention)
  std::vector<uint8_t> mask(h * w, 0);
  for (uint64_t x = 0; x < ws; ++x)
    for (uint64_t y = 0; y < hs; ++y)
      if (up[x * hs + y]) mask[(x / S) * h + (y / S)] = 1;
  return rleEncode(mask.data(), h, w);
}

// -------------------------------------------------- LEB128-style string codec
// Same scheme as maskApi.c rleToString/rleFrString: 6-bit groups, bit 0x20 =
// continuation, with delta coding of counts from the 3rd run on.
uint64_t rleToString(const RLE* r, char* out) {
  uint64_t p = 0;
  for (uint64_t i = 0; i < r->m; ++i) {
    int64_t x = (int64_t)r->cnts[i];
    if (i > 2) x -= (int64_t)r->cnts[i - 2];
    bool more = true;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      c += 48;
      out[p++] = (char)c;
    }
  }
  out[p] = 0;
  return p;
}

RLE* rleFrString(const char* s, uint64_t h, uint64_t w) {
  std::vector<uint32_t> cnts;
  uint64_t p = 0;
  while (s[p]) {
    int64_t x = 0;
    int64_t k = 0;
    bool more = true;
    while (more) {
      int64_t c = (int64_t)s[p] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++p;
      ++k;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (cnts.size() > 2) x += (int64_t)cnts[cnts.size() - 2];
    cnts.push_back((uint32_t)x);
  }
  RLE* r = rle_alloc(h, w, cnts.size());
  std::copy(cnts.begin(), cnts.end(), r->cnts);
  return r;
}

// ---------------------------------------------------------------- accessors
uint64_t rleRuns(const RLE* r) { return r->m; }
uint64_t rleH(const RLE* r) { return r->h; }
uint64_t rleW(const RLE* r) { return r->w; }
void rleCounts(const RLE* r, uint32_t* out) { std::memcpy(out, r->cnts, r->m * 4); }
RLE* rleFromCounts(uint64_t h, uint64_t w, const uint32_t* cnts, uint64_t m) {
  RLE* r = rle_alloc(h, w, m);
  std::copy(cnts, cnts + m, r->cnts);
  return r;
}

}  // extern "C"
