// DDWS shard codec: the native reader of the table store's shard files.
//
// The port's copy of ddw_tpu/native/codec.cpp, the same source below this
// header. Shard-file parsing in C++, so the loader's per-record cost is one
// index pass over the buffer instead of a Python struct.unpack per field.
//
// Format (little-endian, see ddw_tpu_torch/data/store.py):
//   magic "DDWS" | u32 format_version | u32 nrecords
//   per record: u32 path_len, path, u32 content_len, content,
//               u32 label_len, label, i32 label_idx
//
// C ABI (ctypes): ddws_index_shard() parses a whole in-memory shard buffer and
// fills caller-visible offset/length arrays; the Python side slices the buffer.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parsed per-record field locations within the shard buffer.
typedef struct {
  int64_t path_off, path_len;
  int64_t content_off, content_len;
  int64_t label_off, label_len;
  int32_t label_idx;
  int32_t _pad;
} DdwsRecordIndex;

// Returns number of records on success (>= 0), or a negative error code:
//   -1 bad magic, -2 unsupported version, -3 truncated buffer,
//   -4 capacity too small (call again with the returned count via
//      ddws_count_records).
int64_t ddws_index_shard(const uint8_t* buf, int64_t buf_len,
                         DdwsRecordIndex* out, int64_t capacity) {
  if (buf_len < 12 || memcmp(buf, "DDWS", 4) != 0) return -1;
  uint32_t version, nrec;
  memcpy(&version, buf + 4, 4);
  memcpy(&nrec, buf + 8, 4);
  if (version != 1) return -2;
  if ((int64_t)nrec > capacity) return -4;

  int64_t off = 12;
  for (uint32_t i = 0; i < nrec; ++i) {
    DdwsRecordIndex* r = &out[i];
    uint32_t len;

    if (off + 4 > buf_len) return -3;
    memcpy(&len, buf + off, 4);
    off += 4;
    if (off + len > buf_len) return -3;
    r->path_off = off;
    r->path_len = len;
    off += len;

    if (off + 4 > buf_len) return -3;
    memcpy(&len, buf + off, 4);
    off += 4;
    if (off + len > buf_len) return -3;
    r->content_off = off;
    r->content_len = len;
    off += len;

    if (off + 4 > buf_len) return -3;
    memcpy(&len, buf + off, 4);
    off += 4;
    if (off + len > buf_len) return -3;
    r->label_off = off;
    r->label_len = len;
    off += len;

    if (off + 4 > buf_len) return -3;
    memcpy(&r->label_idx, buf + off, 4);
    off += 4;
  }
  return (int64_t)nrec;
}

// Record count without a full index pass (header only).
int64_t ddws_count_records(const uint8_t* buf, int64_t buf_len) {
  if (buf_len < 12 || memcmp(buf, "DDWS", 4) != 0) return -1;
  uint32_t version, nrec;
  memcpy(&version, buf + 4, 4);
  memcpy(&nrec, buf + 8, 4);
  if (version != 1) return -2;
  return (int64_t)nrec;
}

// Validate full-shard framing (same walk as indexing, no output).
int64_t ddws_validate(const uint8_t* buf, int64_t buf_len) {
  int64_t n = ddws_count_records(buf, buf_len);
  if (n < 0) return n;
  DdwsRecordIndex* scratch =
      (DdwsRecordIndex*)malloc(sizeof(DdwsRecordIndex) * (size_t)n);
  if (!scratch) return -5;
  int64_t rc = ddws_index_shard(buf, buf_len, scratch, n);
  free(scratch);
  return rc;
}

}  // extern "C"
