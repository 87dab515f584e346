// Strict re-creation of Kaldi's archive framing rules, used to verify the
// ark/scp byte contract without a Kaldi install. The port's copy of
// native/kaldi_consumer.cpp (bound by tfkaldi_tpu_torch/io/kaldi_compat.py).
//
// This is NOT derived from the reference repo (which has no native code,
// SURVEY §2.3); it independently implements the documented behavior of the
// Kaldi C++ I/O stack that consumes our files at the pipeline boundary
// (copy-feats / latgen-faster-mapped, reference kaldi/decode.sh:54-62):
//
//  - SequentialTableReader archive framing (kaldi/src/util/kaldi-table-inl.h,
//    SequentialTableReaderArchiveImpl::Next): `stream >> key` then EXACTLY
//    ONE whitespace byte must follow the key, else
//    "Invalid archive file format" — this is the rule the reference's own
//    writer violates by omitting the space (reference processing/ark.py:204),
//    and why our ArkWriter deliberately emits "key " + value.
//  - InitKaldiInputStream (kaldi/src/base/kaldi-utils + io-funcs): a binary
//    record begins "\0B".
//  - Matrix<float>::Read (kaldi/src/matrix/kaldi-matrix.cc): ReadToken
//    ("FM"/"DM"/"CM", terminated by exactly one consumed space), then
//    ReadBasicType<int32> twice (a size byte == sizeof(int32) == 4, then 4
//    native-endian bytes) for rows/cols, then rows*cols row-major values.
//  - RandomAccessTableReader over an scp (kaldi/src/util/kaldi-io.cc,
//    OffsetFileInputImpl): "path:offset" seeks to `offset`, where the
//    binary header "\0B" must begin — i.e. scp offsets point AFTER the
//    "key " prefix.
//  - TableWriter archive framing (TableWriterArchiveImpl::Write): key + ' '
//    + value; with "ark,scp:" the scp line's offset is the post-key
//    position. kc_copy_feats below reproduces copy-feats' read->rewrite
//    loop with those rules.
//
// Error codes (negative) identify which Kaldi rule a malformed file breaks.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kErrOpen = -1;          // cannot open file
constexpr int kErrEof = -2;           // EOF before requested record
constexpr int kErrKey = -3;           // could not read a key token
constexpr int kErrNoSpace = -4;       // no single whitespace byte after key
constexpr int kErrNotBinary = -5;     // record does not start with \0B
constexpr int kErrToken = -6;         // matrix token not FM/DM (or bad framing)
constexpr int kErrSizeMarker = -7;    // int32 size byte != 4
constexpr int kErrShortData = -8;     // EOF inside the data payload
constexpr int kErrCapacity = -9;      // caller buffer too small
constexpr int kErrWrite = -10;        // output write failure
constexpr int kErrBadDims = -11;      // negative rows/cols

bool is_kaldi_space(int c) { return c == ' ' || c == '\t' || c == '\n' || c == '\r'; }

// `stream >> key`: skip leading whitespace, take bytes until whitespace/EOF.
// Returns false on EOF with no token (normal end of archive).
bool read_key(std::FILE* f, std::string* key) {
  int c;
  do {
    c = std::fgetc(f);
  } while (c != EOF && is_kaldi_space(c));
  if (c == EOF) return false;
  key->clear();
  while (c != EOF && !is_kaldi_space(c)) {
    key->push_back(static_cast<char>(c));
    c = std::fgetc(f);
  }
  if (c != EOF) std::ungetc(c, f);
  return true;
}

int read_i32(std::FILE* f, int32_t* out) {
  int marker = std::fgetc(f);
  if (marker == EOF) return kErrShortData;
  if (marker != 4) return kErrSizeMarker;  // ReadBasicType size check
  if (std::fread(out, 4, 1, f) != 1) return kErrShortData;
  return 0;
}

// Binary matrix value starting at the current position: "\0B" + "FM "/"DM "
// + dims + payload. Fills rows/cols; writes float32 data into out (cap
// elements) if out != nullptr.
int read_binary_matrix(std::FILE* f, float* out, long cap, int32_t* rows,
                       int32_t* cols) {
  int c0 = std::fgetc(f);
  int c1 = std::fgetc(f);
  if (c0 != '\0' || c1 != 'B') return kErrNotBinary;  // InitKaldiInputStream
  // ReadToken: bytes until whitespace, then exactly one consumed space.
  std::string token;
  int c;
  while ((c = std::fgetc(f)) != EOF && !is_kaldi_space(c)) {
    token.push_back(static_cast<char>(c));
    if (token.size() > 4) return kErrToken;
  }
  if (c != ' ') return kErrToken;  // Kaldi's ReadToken expects the space
  bool is_double;
  if (token == "FM") {
    is_double = false;
  } else if (token == "DM") {
    is_double = true;
  } else {
    return kErrToken;  // "CM" (compressed) and text are out of contract scope
  }
  int rc = read_i32(f, rows);
  if (rc) return rc;
  rc = read_i32(f, cols);
  if (rc) return rc;
  if (*rows < 0 || *cols < 0) return kErrBadDims;
  long n = static_cast<long>(*rows) * *cols;
  if (out == nullptr) {
    // skip the payload
    long bytes = n * (is_double ? 8 : 4);
    if (std::fseek(f, bytes, SEEK_CUR) != 0) return kErrShortData;
    // fseek past EOF succeeds on POSIX; verify by probing one byte back
    if (bytes > 0) {
      if (std::fseek(f, -1, SEEK_CUR) != 0) return kErrShortData;
      if (std::fgetc(f) == EOF) return kErrShortData;
    }
    return 0;
  }
  if (n > cap) return kErrCapacity;
  if (is_double) {
    std::vector<double> tmp(n);
    if (n > 0 && std::fread(tmp.data(), 8, n, f) != static_cast<size_t>(n))
      return kErrShortData;
    for (long i = 0; i < n; ++i) out[i] = static_cast<float>(tmp[i]);
  } else {
    if (n > 0 && std::fread(out, 4, n, f) != static_cast<size_t>(n))
      return kErrShortData;
  }
  return 0;
}

// One sequential record: key, the single-space rule, then the value.
int read_record(std::FILE* f, std::string* key, float* out, long cap,
                int32_t* rows, int32_t* cols) {
  if (!read_key(f, key)) return kErrEof;
  if (key->empty()) return kErrKey;
  int c = std::fgetc(f);
  if (c == EOF || !is_kaldi_space(c)) return kErrNoSpace;  // the space-after-key rule
  return read_binary_matrix(f, out, cap, rows, cols);
}

}  // namespace

extern "C" {

// Number of well-formed records read sequentially until clean EOF, or a
// negative error code at the first malformed record.
long kc_count(const char* path) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return kErrOpen;
  long count = 0;
  std::string key;
  int32_t rows, cols;
  while (true) {
    int rc = read_record(f, &key, nullptr, 0, &rows, &cols);
    if (rc == kErrEof) break;
    if (rc) {
      std::fclose(f);
      return rc;
    }
    ++count;
  }
  std::fclose(f);
  return count;
}

// Sequentially consume `index` records, then read record `index` fully.
int kc_seq_read(const char* path, long index, char* key_out, int key_cap,
                float* out, long cap, int* rows, int* cols) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return kErrOpen;
  std::string key;
  int32_t r = 0, c = 0;
  int rc = 0;
  for (long i = 0; i <= index; ++i) {
    bool last = (i == index);
    rc = read_record(f, &key, last ? out : nullptr, cap, &r, &c);
    if (rc) break;
  }
  std::fclose(f);
  *rows = r;  // reported even on kErrCapacity so callers can resize
  *cols = c;
  if (rc) return rc;
  if (static_cast<int>(key.size()) + 1 > key_cap) return kErrCapacity;
  std::memcpy(key_out, key.c_str(), key.size() + 1);
  return 0;
}

// Random access through an scp offset: the binary header must start AT
// `offset` (Kaldi OffsetFileInputImpl seeks there and reads the value).
int kc_read_at(const char* path, long offset, float* out, long cap, int* rows,
               int* cols) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return kErrOpen;
  if (std::fseek(f, offset, SEEK_SET) != 0) {
    std::fclose(f);
    return kErrEof;
  }
  int32_t r = 0, c = 0;
  int rc = read_binary_matrix(f, out, cap, &r, &c);
  std::fclose(f);
  *rows = r;  // reported even on kErrCapacity so callers can resize
  *cols = c;
  return rc;
}

// copy-feats equivalent: strict sequential read of in_ark, rewrite every
// record with Kaldi's TableWriter framing ("key " + "\0BFM " + dims + f32
// payload; DM input is converted to FM exactly as copy-feats' BaseFloat
// pipeline does), emitting scp offsets at the post-key position.
// Returns #records copied or a negative error code.
long kc_copy_feats(const char* in_ark, const char* out_ark,
                   const char* out_scp) {
  std::FILE* f = std::fopen(in_ark, "rb");
  if (!f) return kErrOpen;
  std::FILE* fo = std::fopen(out_ark, "wb");
  std::FILE* fs = std::fopen(out_scp, "w");
  if (!fo || !fs) {
    std::fclose(f);
    if (fo) std::fclose(fo);
    if (fs) std::fclose(fs);
    return kErrOpen;
  }
  std::string key;
  int32_t rows, cols;
  std::vector<float> buf;
  long count = 0;
  int rc = 0;
  while (true) {
    // probe dims first (two-pass keeps the buffer exact)
    long pos = std::ftell(f);
    rc = read_record(f, &key, nullptr, 0, &rows, &cols);
    if (rc == kErrEof) {
      rc = 0;
      break;
    }
    if (rc) break;
    std::fseek(f, pos, SEEK_SET);
    buf.resize(static_cast<size_t>(rows) * cols);
    rc = read_record(f, &key, buf.data(), static_cast<long>(buf.size()), &rows,
                     &cols);
    if (rc) break;
    if (std::fwrite(key.data(), 1, key.size(), fo) != key.size() ||
        std::fputc(' ', fo) == EOF) {
      rc = kErrWrite;
      break;
    }
    long offset = std::ftell(fo);
    const unsigned char header[] = {0, 'B', 'F', 'M', ' '};
    const unsigned char size4 = 4;
    if (std::fwrite(header, 1, 5, fo) != 5 ||
        std::fwrite(&size4, 1, 1, fo) != 1 ||
        std::fwrite(&rows, 4, 1, fo) != 1 ||
        std::fwrite(&size4, 1, 1, fo) != 1 ||
        std::fwrite(&cols, 4, 1, fo) != 1 ||
        (buf.size() > 0 &&
         std::fwrite(buf.data(), 4, buf.size(), fo) != buf.size())) {
      rc = kErrWrite;
      break;
    }
    if (std::fprintf(fs, "%s %s:%ld\n", key.c_str(), out_ark, offset) < 0) {
      rc = kErrWrite;
      break;
    }
    ++count;
  }
  std::fclose(f);
  std::fclose(fo);
  std::fclose(fs);
  return rc ? rc : count;
}

}  // extern "C"
