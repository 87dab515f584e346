// Native bulk Kaldi-ark data loader.
//
// The port's own copy of native/arkio.cpp, built by
// tfkaldi_tpu_torch/io/native.py with g++ into build/tfkaldi_tpu_torch/.
//
// The reference's data path is pure-Python: per-utterance struct parsing,
// numpy CMVN and splicing (processing/ark.py:59-94,
// processing/feature_reader.py:91-156). This library does the host-side
// hot loop in C++: bulk-read binary matrix records straight into a
// caller-provided padded batch buffer, optionally fusing per-speaker CMVN
// normalization and ±context splicing so Python touches the data zero
// times. Exposed via ctypes (no pybind11 in this image).
//
// Record layout handled (see tfkaldi_tpu_torch/io/ark.py):
//   \x00 'B' {F|D} 'M' ' ' \x04 <rows:int32le> \x04 <cols:int32le> <data>
// The scp offset points at the leading \x00.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Header {
  int64_t rows;
  int64_t cols;
  bool is_double;
};

// Returns 0 on success, nonzero error code otherwise.
int read_header(FILE* f, int64_t offset, Header* h) {
  if (fseeko(f, offset, SEEK_SET) != 0) return 1;
  unsigned char head[5];
  if (fread(head, 1, 5, f) != 5) return 2;
  if (head[0] != 0x00 || head[1] != 'B') return 3;  // not binary mode
  if (head[2] == 'C') return 4;                     // compressed: unsupported
  if (head[2] == 'F') h->is_double = false;
  else if (head[2] == 'D') h->is_double = true;
  else return 5;
  if (head[3] != 'M') return 6;
  unsigned char szr[5], szc[5];
  if (fread(szr, 1, 5, f) != 5 || szr[0] != 4) return 7;
  if (fread(szc, 1, 5, f) != 5 || szc[0] != 4) return 8;
  int32_t rows, cols;
  std::memcpy(&rows, szr + 1, 4);
  std::memcpy(&cols, szc + 1, 4);
  // reject negative dims here: a corrupted rows field that went negative
  // would pass a `rows > max_rows` cap downstream, and the (size_t) cast
  // of the negative element count would turn the payload fread into an
  // unbounded write over the caller's batch buffer
  if (rows < 0 || cols < 0) return 10;
  h->rows = rows;
  h->cols = cols;
  return 0;
}

int read_matrix_f32(FILE* f, const Header& h, float* dst) {
  const int64_t n = h.rows * h.cols;
  if (!h.is_double) {
    if (fread(dst, sizeof(float), (size_t)n, f) != (size_t)n) return 9;
    return 0;
  }
  std::vector<double> tmp((size_t)n);
  if (fread(tmp.data(), sizeof(double), (size_t)n, f) != (size_t)n) return 9;
  for (int64_t i = 0; i < n; ++i) dst[i] = (float)tmp[i];
  return 0;
}

}  // namespace

extern "C" {

// Bulk-read n matrix records from one ark file into a padded batch buffer.
//
// out:      [n, max_rows, cols] float32, fully overwritten (padding zeroed)
// rows_out: [n] actual row counts
// Every record must have exactly `cols` columns and at most `max_rows`
// rows. Returns 0 on success or -(i+1) if record i failed.
int ark_read_batch(const char* path, const int64_t* offsets, int32_t n,
                   int64_t max_rows, int64_t cols, float* out,
                   int32_t* rows_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1000000;
  const int64_t stride = max_rows * cols;
  for (int32_t i = 0; i < n; ++i) {
    Header h;
    if (read_header(f, offsets[i], &h) != 0 || h.cols != cols ||
        h.rows > max_rows) {
      fclose(f);
      return -(i + 1);
    }
    float* dst = out + (int64_t)i * stride;
    if (read_matrix_f32(f, h, dst) != 0) {
      fclose(f);
      return -(i + 1);
    }
    std::memset(dst + h.rows * cols, 0,
                sizeof(float) * (size_t)((max_rows - h.rows) * cols));
    rows_out[i] = (int32_t)h.rows;
  }
  fclose(f);
  return 0;
}

// Bulk-read + per-utterance CMVN + ±context splice, fused.
//
// cmvn:  [n, 2, dim+1] float32 — each utterance's speaker stats, Kaldi
//        layout (row0 = Σx with count last, row1 = Σx²; see
//        tfkaldi_tpu/frontend/cmvn.py).
// out:   [n, max_rows, dim*(2c+1)] float32 (padding + out-of-range context
//        zeroed — matches feature_reader.py:117-156 zero-edge splicing)
// rows_out[i] = frame count, or -1 if the utterance is too short to
// splice (< 2c+1 frames; the caller skips those, batchdispenser.py:85-90).
// Returns 0, or -(i+1) on a read failure at record i.
int ark_read_cmvn_splice_batch(const char* path, const int64_t* offsets,
                               int32_t n, const float* cmvn, int32_t context,
                               int64_t max_rows, int64_t dim, float* out,
                               int32_t* rows_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1000000;
  const int64_t width = 2 * (int64_t)context + 1;
  const int64_t out_cols = dim * width;
  const int64_t stride = max_rows * out_cols;
  std::vector<float> utt;
  std::vector<float> mean(dim), stddev(dim);

  for (int32_t i = 0; i < n; ++i) {
    Header h;
    if (read_header(f, offsets[i], &h) != 0 || h.cols != dim ||
        h.rows > max_rows) {
      fclose(f);
      return -(i + 1);
    }
    float* dst = out + (int64_t)i * stride;
    std::memset(dst, 0, sizeof(float) * (size_t)stride);
    if (h.rows < width) {  // too short to splice
      rows_out[i] = -1;
      continue;
    }
    utt.resize((size_t)(h.rows * dim));
    if (read_matrix_f32(f, h, utt.data()) != 0) {
      fclose(f);
      return -(i + 1);
    }

    const float* s = cmvn + (int64_t)i * 2 * (dim + 1);
    const float count = s[dim];
    for (int64_t d = 0; d < dim; ++d) {
      const float m = s[d] / count;
      const float var = s[(dim + 1) + d] / count - m * m;
      mean[d] = m;
      // no epsilon, like the reference (feature_reader.py:91-115)
      stddev[d] = std::sqrt(var);
    }

    for (int64_t t = 0; t < h.rows; ++t) {
      float* row = dst + t * out_cols;
      for (int64_t o = 0; o < width; ++o) {
        const int64_t src_t = t + o - context;
        if (src_t < 0 || src_t >= h.rows) continue;  // zero edge padding
        const float* src = utt.data() + src_t * dim;
        float* block = row + o * dim;
        for (int64_t d = 0; d < dim; ++d) {
          // a true f32 division (not *reciprocal): bit-identical to the
          // numpy fallback path's (x - mean) / sqrt(var), so the native
          // and Python dispensers produce byte-equal batches and the
          // production wiring can be verified loss-for-loss
          block[d] = (src[d] - mean[d]) / stddev[d];
        }
      }
    }
    rows_out[i] = (int32_t)h.rows;
  }
  fclose(f);
  return 0;
}

}  // extern "C"
