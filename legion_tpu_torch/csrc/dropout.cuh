// Dropout's keep bits, drawn inside a kernel from the step's dropout key:
// K16 dropout_act (dropout.cu), and GAT's attention dropout inside K6
// gat_attend (gat_attend.cu) and K7 hop_attention (hop_attention.cu).
//
// A call's key is (ka, kb) = lt_fold_in(words, fold): words the step's two
// dropout key words that K10 writes on the card (step_keys.cu), fold the
// layer (feature dropout) or ATTN_TAG << 32 | layer (attention dropout,
// ops/dropout.py::attn_fold). Lane e is the row-major element index of the
// dropped tensor (< 2^32). The regimes of legion_tpu/models/common.py::
// dropout (:71-99):
//   1 (rate 0.5, 2-D, width % 32 == 0): bit e % 32 of lt_word(e / 32);
//   2 (2^20 elements or more): byte e % 4 of lt_word(e / 4) below kq;
//   3 (otherwise): (lt_word(e) >> 8) * 2^-24 < keep, in f32;
//   0 (rate 0): every lane kept, no scaling.
// The plain version is ops/dropout.py::keep_mask_plain.
#pragma once

#include "common.cuh"

struct Drop {
  uint32_t ka, kb;
  int regime;
  uint32_t kq;  // regime 2's threshold on a byte
  float keep;   // regime 3's threshold, keep in f32
  float c;      // the divisor (regimes 1, 3) or factor (2), in y's dtype
};

__device__ __forceinline__ Drop make_drop(const int32_t* words,
                                          uint64_t fold, int regime,
                                          uint32_t kq, float keep, float c) {
  Drop d{0u, 0u, regime, kq, keep, c};
  if (regime != 0) {
    LtKey k{(uint32_t)words[0], (uint32_t)words[1]};
    k = lt_fold_in(k, fold);
    d.ka = k.lo;
    d.kb = k.hi;
  }
  return d;
}

// What a launch passes for dropout: the key words on the card, the fold
// and the regime's constants; each thread makes its Drop from them.
struct DropArgs {
  const int32_t* words;
  uint64_t fold;
  int regime;
  uint32_t kq;
  float keep, c;
};

// A launch's dropout arguments out of range: a regime past 3, or no key
// words where the regime reads them.
inline bool bad_drop(const DropArgs& d) {
  return d.regime < 0 || d.regime > 3 ||
         (d.regime != 0 && d.words == nullptr);
}

__device__ __forceinline__ Drop make_drop(const DropArgs& a) {
  return make_drop(a.words, a.fold, a.regime, a.kq, a.keep, a.c);
}

// Lane e's keep bit, with no branch (the regime picks the word's index
// and its test by selects), so that a kernel's loads around it need not
// wait on one; regime 0 keeps every lane.
__device__ __forceinline__ bool keep_lane(const Drop& d, uint32_t e) {
  const uint32_t w = lt_word(d.ka, d.kb,
                             d.regime == 1 ? e >> 5
                                           : (d.regime == 2 ? e >> 2 : e));
  const bool bit = (w >> (e & 31u)) & 1u;
  const bool byte = ((w >> (8u * (e & 3u))) & 0xFFu) < d.kq;
  const bool uniform =
      (float)(w >> 8) * 5.9604644775390625e-8f < d.keep;
  return d.regime == 0 ||
         (d.regime == 1 ? bit : (d.regime == 2 ? byte : uniform));
}

// An f32 value of lane `kept` through dropout, as JAX's
// where(mask, v / keep, 0) (v * (256 / kq) in regime 2) takes it: IEEE
// division, so no -use_fast_math; v itself in regime 0.
__device__ __forceinline__ float drop_f32(const Drop& d, bool kept,
                                          float v) {
  if (d.regime == 0) return v;
  if (!kept) return 0.0f;
  return d.regime == 2 ? v * d.c : v / d.c;
}
