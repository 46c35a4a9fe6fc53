// limg-tpu native host runtime.
//
// The reference's native layer is a std::thread pool that shards *compute*
// (src/limg_threading.cpp) plus vendored stb image IO (src/main.cpp:17-21).
// On TPU the compute parallelism lives on the device, so the native layer's
// job moves to the host data path: decode images, relayout them into the
// packed (pixels, blocks) tensors the device kernels consume, write debug
// planes, and keep a worker pool streaming a corpus so host staging overlaps
// device encode.
//
// Exposed as extern "C" for ctypes (no pybind11 in this environment).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

constexpr int kBlock = 8;

#pragma pack(push, 1)
struct TgaHeader {
  uint8_t id_length = 0;
  uint8_t color_map_type = 0;
  uint8_t image_type = 0;  // 2 = truecolor, 3 = grayscale
  uint16_t cmap_origin = 0;
  uint16_t cmap_length = 0;
  uint8_t cmap_depth = 0;
  uint16_t x_origin = 0;
  uint16_t y_origin = 0;
  uint16_t width = 0;
  uint16_t height = 0;
  uint8_t bpp = 0;
  uint8_t descriptor = 0;
};
#pragma pack(pop)

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Blockify: (H, W) RGBA u32 image -> packed (64, NB) u32 block tensor in
// row-major in-block pixel order plus a (64, NB) u8 validity mask.
// NB = ceil(H/8) * ceil(W/8); edge blocks are zero-padded.
// The layout matches limg_tpu.ops.layout.blockify + pallas pack_channels.
// ---------------------------------------------------------------------------
void limg_rt_blockify_u32(const uint32_t* image, int64_t h, int64_t w,
                          uint32_t* out_packed, uint8_t* out_mask) {
  const int64_t by = (h + kBlock - 1) / kBlock;
  const int64_t bx = (w + kBlock - 1) / kBlock;
  const int64_t nb = by * bx;
  for (int64_t iy = 0; iy < by; iy++) {
    for (int64_t ix = 0; ix < bx; ix++) {
      const int64_t block = iy * bx + ix;
      for (int64_t py = 0; py < kBlock; py++) {
        const int64_t y = iy * kBlock + py;
        for (int64_t px = 0; px < kBlock; px++) {
          const int64_t x = ix * kBlock + px;
          const int64_t p = py * kBlock + px;
          const bool valid = (y < h) & (x < w);
          out_packed[p * nb + block] = valid ? image[y * w + x] : 0u;
          out_mask[p * nb + block] = valid ? 1 : 0;
        }
      }
    }
  }
}

// Inverse: packed (64, NB) u32 -> (H, W) RGBA u32 (crops padding).
void limg_rt_unblockify_u32(const uint32_t* packed, int64_t h, int64_t w,
                            uint32_t* out_image) {
  const int64_t by = (h + kBlock - 1) / kBlock;
  const int64_t bx = (w + kBlock - 1) / kBlock;
  const int64_t nb = by * bx;
  for (int64_t y = 0; y < h; y++) {
    for (int64_t x = 0; x < w; x++) {
      const int64_t block = (y / kBlock) * bx + (x / kBlock);
      const int64_t p = (y % kBlock) * kBlock + (x % kBlock);
      out_image[y * w + x] = packed[p * nb + block];
    }
  }
}

// ---------------------------------------------------------------------------
// TGA write (type 2 truecolor BGRA / type 3 grayscale), top-left origin.
// Matches the debug dumps the reference emits via stb (src/main.cpp:350-370).
// ---------------------------------------------------------------------------
int limg_rt_write_tga_rgba(const char* path, const uint32_t* rgba,
                           int64_t h, int64_t w) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  TgaHeader hdr;
  hdr.image_type = 2;
  hdr.width = (uint16_t)w;
  hdr.height = (uint16_t)h;
  hdr.bpp = 32;
  hdr.descriptor = 0x28;  // top-left, 8 alpha bits
  fwrite(&hdr, sizeof(hdr), 1, f);
  std::vector<uint32_t> row(w);
  for (int64_t y = 0; y < h; y++) {
    for (int64_t x = 0; x < w; x++) {
      const uint32_t v = rgba[y * w + x];  // 0xAABBGGRR in memory order
      row[x] = (v & 0xFF00FF00u) | ((v & 0xFFu) << 16) | ((v >> 16) & 0xFFu);
    }
    fwrite(row.data(), 4, w, f);
  }
  fclose(f);
  return 0;
}

int limg_rt_write_tga_gray(const char* path, const uint8_t* gray,
                           int64_t h, int64_t w) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  TgaHeader hdr;
  hdr.image_type = 3;
  hdr.width = (uint16_t)w;
  hdr.height = (uint16_t)h;
  hdr.bpp = 8;
  hdr.descriptor = 0x20;  // top-left
  fwrite(&hdr, sizeof(hdr), 1, f);
  fwrite(gray, 1, (size_t)h * w, f);
  fclose(f);
  return 0;
}

// Uncompressed truecolor/grayscale TGA reader -> RGBA u32.
// Returns 0 on success; fills *out_h/*out_w when out_rgba is null (probe).
int limg_rt_read_tga(const char* path, uint32_t* out_rgba,
                     int64_t* out_h, int64_t* out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  TgaHeader hdr;
  if (fread(&hdr, sizeof(hdr), 1, f) != 1) { fclose(f); return -2; }
  if (hdr.color_map_type != 0 || (hdr.image_type != 2 && hdr.image_type != 3)) {
    fclose(f);
    return -3;
  }
  fseek(f, hdr.id_length, SEEK_CUR);
  const int64_t h = hdr.height, w = hdr.width;
  if (out_h) *out_h = h;
  if (out_w) *out_w = w;
  if (!out_rgba) { fclose(f); return 0; }
  const int bytes = hdr.bpp / 8;
  const bool top_left = (hdr.descriptor & 0x20) != 0;
  std::vector<uint8_t> row(w * bytes);
  for (int64_t ry = 0; ry < h; ry++) {
    if (fread(row.data(), bytes, w, f) != (size_t)w) { fclose(f); return -4; }
    const int64_t y = top_left ? ry : (h - 1 - ry);
    for (int64_t x = 0; x < w; x++) {
      uint8_t r, g, b, a = 0xFF;
      if (hdr.image_type == 3) {
        r = g = b = row[x];
      } else {
        b = row[x * bytes + 0];
        g = row[x * bytes + 1];
        r = row[x * bytes + 2];
        if (bytes == 4) a = row[x * bytes + 3];
      }
      out_rgba[y * w + x] =
          (uint32_t)r | ((uint32_t)g << 8) | ((uint32_t)b << 16) | ((uint32_t)a << 24);
    }
  }
  fclose(f);
  return 0;
}

// Binary PPM (P6) reader -> RGBA u32.
int limg_rt_read_ppm(const char* path, uint32_t* out_rgba,
                     int64_t* out_h, int64_t* out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char magic[3] = {0};
  int w = 0, h = 0, maxv = 0;
  if (fscanf(f, "%2s %d %d %d", magic, &w, &h, &maxv) != 4 ||
      strcmp(magic, "P6") != 0 || maxv != 255) {
    fclose(f);
    return -3;
  }
  fgetc(f);  // single whitespace after header
  if (out_h) *out_h = h;
  if (out_w) *out_w = w;
  if (!out_rgba) { fclose(f); return 0; }
  std::vector<uint8_t> row((size_t)w * 3);
  for (int64_t y = 0; y < h; y++) {
    if (fread(row.data(), 3, w, f) != (size_t)w) { fclose(f); return -4; }
    for (int64_t x = 0; x < w; x++) {
      out_rgba[y * w + x] = (uint32_t)row[x * 3] | ((uint32_t)row[x * 3 + 1] << 8) |
                            ((uint32_t)row[x * 3 + 2] << 16) | 0xFF000000u;
    }
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Corpus staging pool: worker threads decode + blockify files into
// caller-provided slots so host IO overlaps device encode. The device-side
// analog of the reference's limg_thread_pool (src/limg_threading.h:9-17).
// ---------------------------------------------------------------------------
struct limg_rt_pool {
  std::vector<std::thread> workers;
  std::queue<std::function<void()>> tasks;
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<int64_t> pending{0};
  bool stop = false;
};

limg_rt_pool* limg_rt_pool_new(int threads) {
  auto* p = new limg_rt_pool();
  if (threads < 1) threads = 1;
  for (int i = 0; i < threads; i++) {
    p->workers.emplace_back([p] {
      while (true) {
        std::function<void()> task;
        {
          std::unique_lock<std::mutex> lk(p->mu);
          p->cv.wait(lk, [p] { return p->stop || !p->tasks.empty(); });
          if (p->stop && p->tasks.empty()) return;
          task = std::move(p->tasks.front());
          p->tasks.pop();
        }
        task();
        p->pending.fetch_sub(1);
      }
    });
  }
  return p;
}

void limg_rt_pool_destroy(limg_rt_pool* p) {
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

int limg_rt_pool_thread_count(limg_rt_pool* p) { return (int)p->workers.size(); }

// Stage one file: decode (TGA/PPM by extension) and blockify into the given
// slot buffers. status: 0 queued-ok result written asynchronously; slot
// status cell becomes 1 on success, <0 on failure.
void limg_rt_pool_stage_file(limg_rt_pool* p, const char* path,
                             uint32_t* packed_slot, uint8_t* mask_slot,
                             int64_t h, int64_t w, int32_t* status_cell) {
  std::string spath(path);
  p->pending.fetch_add(1);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->tasks.push([spath, packed_slot, mask_slot, h, w, status_cell] {
      std::vector<uint32_t> img((size_t)h * w);
      int rc = -10;
      const size_t n = spath.size();
      if (n > 4 && spath.compare(n - 4, 4, ".tga") == 0)
        rc = limg_rt_read_tga(spath.c_str(), img.data(), nullptr, nullptr);
      else if (n > 4 && spath.compare(n - 4, 4, ".ppm") == 0)
        rc = limg_rt_read_ppm(spath.c_str(), img.data(), nullptr, nullptr);
      if (rc == 0) {
        limg_rt_blockify_u32(img.data(), h, w, packed_slot, mask_slot);
        *status_cell = 1;
      } else {
        *status_cell = rc;
      }
    });
  }
  p->cv.notify_one();
}

void limg_rt_pool_await(limg_rt_pool* p) {
  while (p->pending.load() > 0) std::this_thread::yield();
}

int64_t limg_rt_max_threads() {
  return (int64_t)std::thread::hardware_concurrency();
}

// ---------------------------------------------------------------------------
// rANS entropy codec (order-0, static 12-bit quantized frequencies).
//
// Used by the LTP1 v3 bitstream to entropy-code the crushed factor planes --
// a capability the reference lacks entirely (it has no bitstream; a dead
// buffer prototype sits at src/limg_internal.h:96-144). 32-bit state, byte
// renormalization; the encoder walks symbols in reverse and the byte stream
// is reversed at the end so the decoder reads forward.
// ---------------------------------------------------------------------------

namespace {

constexpr uint32_t kRansProbBits = 12;
constexpr uint32_t kRansProbScale = 1u << kRansProbBits;
constexpr uint32_t kRansLow = 1u << 23;

}  // namespace

// freqs: u32[256], quantized so that sum == 4096 and every symbol that
// occurs has freq >= 1 (the Python side quantizes). Returns bytes written,
// or -1 if out_cap is too small.
int64_t limg_rt_rans_encode(const uint8_t* syms, int64_t n,
                            const uint32_t* freqs, uint8_t* out,
                            int64_t out_cap) {
  uint32_t starts[257];
  starts[0] = 0;
  for (int i = 0; i < 256; i++) starts[i + 1] = starts[i] + freqs[i];
  if (starts[256] != kRansProbScale) return -2;

  std::vector<uint8_t> rev;
  rev.reserve((size_t)n + 16);
  uint32_t state = kRansLow;
  for (int64_t i = n - 1; i >= 0; i--) {
    const uint32_t s = syms[i];
    const uint32_t f = freqs[s];
    const uint32_t x_max = ((kRansLow >> kRansProbBits) << 8) * f;
    while (state >= x_max) {
      rev.push_back((uint8_t)(state & 0xFF));
      state >>= 8;
    }
    state = ((state / f) << kRansProbBits) + (state % f) + starts[s];
  }
  for (int i = 0; i < 4; i++) {
    rev.push_back((uint8_t)(state & 0xFF));
    state >>= 8;
  }
  const int64_t total = (int64_t)rev.size();
  if (total > out_cap) return -1;
  for (int64_t i = 0; i < total; i++) out[i] = rev[(size_t)(total - 1 - i)];
  return total;
}

// Returns 0 on success.
int limg_rt_rans_decode(const uint8_t* data, int64_t nbytes,
                        const uint32_t* freqs, uint8_t* out, int64_t n) {
  uint32_t starts[257];
  starts[0] = 0;
  for (int i = 0; i < 256; i++) starts[i + 1] = starts[i] + freqs[i];
  if (starts[256] != kRansProbScale) return -2;
  std::vector<uint8_t> slot_sym(kRansProbScale);
  for (int s = 0; s < 256; s++)
    for (uint32_t j = starts[s]; j < starts[s + 1]; j++) slot_sym[j] = (uint8_t)s;

  const uint8_t* p = data;
  const uint8_t* end = data + nbytes;
  if (nbytes < 4) return -3;
  uint32_t state = 0;
  for (int i = 0; i < 4; i++) state = (state << 8) | *p++;
  for (int64_t i = 0; i < n; i++) {
    const uint32_t slot = state & (kRansProbScale - 1);
    const uint8_t s = slot_sym[slot];
    out[i] = s;
    state = freqs[s] * (state >> kRansProbBits) + slot - starts[s];
    while (state < kRansLow) {
      if (p >= end) return -4;
      state = (state << 8) | *p++;
    }
  }
  // the encoder started from exactly kRansLow, so a well-formed stream
  // returns there after the last symbol
  return state == kRansLow ? 0 : -5;
}

// ---------------------------------------------------------------------------
// LTP1 factor-section kernels: the host-side hot path of serialize /
// deserialize (limg_tpu/bitstream.py). The NumPy formulation materializes
// several 8M-element temporaries per axis (gathers, broadcast width/segment
// maps, bit matrices); these single-pass loops replace all of it. The
// reference has no bitstream at all (its size line is an estimate,
// src/limg.cpp:1629-1636) -- this is capability beyond parity, so the design
// owes nothing to reference code.
// ---------------------------------------------------------------------------

// (64, NB) packed factor words (axis k in byte k) -> 3 contiguous
// (NB, 64) u8 planes. Cache-blocked over lane tiles.
void limg_rt_factor_extract(const int32_t* q_words, int64_t nb, uint8_t* out) {
  constexpr int64_t kTile = 128;
  for (int64_t b0 = 0; b0 < nb; b0 += kTile) {
    const int64_t b1 = b0 + kTile < nb ? b0 + kTile : nb;
    for (int64_t p = 0; p < 64; p++) {
      const int32_t* row = q_words + p * nb;
      for (int64_t b = b0; b < b1; b++) {
        const uint32_t v = (uint32_t)row[b];
        out[(size_t)b * 64 + p] = (uint8_t)(v & 0xFF);
        out[(size_t)(nb + b) * 64 + p] = (uint8_t)((v >> 8) & 0xFF);
        out[(size_t)(2 * nb + b) * 64 + p] = (uint8_t)((v >> 16) & 0xFF);
      }
    }
  }
}

namespace {

// LSB-first bit writer matching numpy packbits(bitorder="little").
struct BitWriter {
  uint8_t* out;
  uint64_t acc = 0;
  int nbits = 0;
  void put(uint32_t val, int width) {
    acc |= (uint64_t)val << nbits;
    nbits += width;
    while (nbits >= 8) {
      *out++ = (uint8_t)(acc & 0xFF);
      acc >>= 8;
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits > 0) {
      *out++ = (uint8_t)(acc & 0xFF);
      acc = 0;
      nbits = 0;
    }
  }
};

struct BitReader {
  const uint8_t* in;
  uint64_t acc = 0;
  int nbits = 0;
  uint32_t get(int width) {
    while (nbits < width) {
      acc |= (uint64_t)(*in++) << nbits;
      nbits += 8;
    }
    const uint32_t v = (uint32_t)(acc & ((1u << width) - 1));
    acc >>= width;
    nbits -= width;
    return v;
  }
};

}  // namespace

// One axis's symbol stream: gather the selected blocks' masked pixels in
// stream order, per-segment delta transform (bitstream._delta_seg), symbol
// histogram, and the width-grouped raw bit-packing -- all in ONE pass over
// the data (plus one short pass to place the width-group cursors).
//
// qk (NB, 64) u8 plane; maskb (NB, 64) u8; ck (n_sel) ordered member block
// ids; segk (n_sel) segment rank per ordered block; wb (n_sel) width 1..8.
// Outputs: vals/syms (caller cap = total masked pixels), hist u32[256] of
// syms (caller zeroes), raw_out width-grouped packed bytes,
// group_bytes[9] per-width byte counts. Returns n_vals.
int64_t limg_rt_factor_pack_axis(
    const uint8_t* qk, const uint8_t* maskb, const int32_t* ck,
    const int32_t* segk, const uint8_t* wb, int64_t n_sel,
    uint8_t* vals, uint8_t* syms, uint32_t* hist,
    uint8_t* raw_out, int64_t* group_bytes) {
  // width-group bit counts -> byte-aligned group offsets (ascending width)
  int64_t bits_w[9] = {0};
  for (int64_t i = 0; i < n_sel; i++) {
    const uint8_t* m = maskb + (size_t)ck[i] * 64;
    int cnt = 0;
    for (int p = 0; p < 64; p++) cnt += m[p];
    bits_w[wb[i]] += (int64_t)cnt * wb[i];
  }
  BitWriter wr[9];
  uint8_t* cur = raw_out;
  for (int v = 1; v <= 8; v++) {
    wr[v].out = cur;
    group_bytes[v] = (bits_w[v] + 7) / 8;
    cur += group_bytes[v];
  }
  group_bytes[0] = 0;

  int64_t n = 0;
  int32_t prev_seg = -1;
  uint32_t prev_val = 0;
  for (int64_t i = 0; i < n_sel; i++) {
    const int64_t b = ck[i];
    const int v = wb[i];
    const uint32_t mask = (1u << v) - 1;
    const uint8_t* q = qk + (size_t)b * 64;
    const uint8_t* m = maskb + (size_t)b * 64;
    const int32_t seg = segk[i];
    const bool fresh = seg != prev_seg;
    prev_seg = seg;
    bool first = fresh;
    for (int p = 0; p < 64; p++) {
      if (!m[p]) continue;
      const uint32_t val = q[p];
      vals[n] = (uint8_t)val;
      const uint32_t sym = first ? (val & mask) : ((val - prev_val) & mask);
      first = false;
      syms[n] = (uint8_t)sym;
      hist[sym]++;
      prev_val = val;
      wr[v].put(val & mask, v);
      n++;
    }
  }
  for (int v = 1; v <= 8; v++) wr[v].flush();
  return n;
}

// Inverse of the delta transform + scatter: symbols (rANS-decoded) ->
// values back into the qk plane at the masked pixels of the selected
// blocks. Masked-out pixels keep whatever qk holds (caller zeroes).
void limg_rt_factor_unpack_axis_syms(
    const uint8_t* syms, const uint8_t* maskb, const int32_t* ck,
    const int32_t* segk, const uint8_t* wb, int64_t n_sel, uint8_t* qk) {
  int64_t n = 0;
  int32_t prev_seg = -1;
  uint32_t prev_val = 0;
  for (int64_t i = 0; i < n_sel; i++) {
    const int64_t b = ck[i];
    const uint32_t mask = (1u << wb[i]) - 1;
    uint8_t* q = qk + (size_t)b * 64;
    const uint8_t* m = maskb + (size_t)b * 64;
    const int32_t seg = segk[i];
    bool first = seg != prev_seg;
    prev_seg = seg;
    for (int p = 0; p < 64; p++) {
      if (!m[p]) continue;
      const uint32_t val =
          first ? (uint32_t)syms[n] : ((prev_val + syms[n]) & mask);
      first = false;
      q[p] = (uint8_t)val;
      prev_val = val;
      n++;
    }
  }
}

// Raw-mode inverse: width-grouped packed bytes -> values scattered into the
// qk plane. Groups are ascending width; within a group, blocks keep stream
// order, so one pass per width over the selection.
void limg_rt_factor_unpack_axis_raw(
    const uint8_t* raw, const int64_t* group_bytes, const uint8_t* maskb,
    const int32_t* ck, const uint8_t* wb, int64_t n_sel, uint8_t* qk) {
  const uint8_t* cur = raw;
  for (int v = 1; v <= 8; v++) {
    if (group_bytes[v] == 0) continue;
    BitReader rd{cur};
    for (int64_t i = 0; i < n_sel; i++) {
      if (wb[i] != v) continue;
      const int64_t b = ck[i];
      uint8_t* q = qk + (size_t)b * 64;
      const uint8_t* m = maskb + (size_t)b * 64;
      for (int p = 0; p < 64; p++) {
        if (m[p]) q[p] = (uint8_t)rd.get(v);
      }
    }
    cur += group_bytes[v];
  }
}

// Segment header records (bitstream.py v5): per segment a u16 shift word
// plus 6*ch 12-bit biased endpoint fields, LSB-first bit order. The NumPy
// formulation expands an (nseg, 6ch, 12) bit tensor; this is one pass.
void limg_rt_pack_headers(const int32_t* s_hdr /* (3, nseg) */,
                          const int32_t* ep_hdr /* (nseg, 6ch) */,
                          int64_t nseg, int ch, uint8_t* out) {
  const int nf = 6 * ch;
  const int rec = 2 + nf * 12 / 8;
  for (int64_t i = 0; i < nseg; i++) {
    uint8_t* r = out + (size_t)i * rec;
    const uint32_t sw = (uint32_t)s_hdr[i] | ((uint32_t)s_hdr[nseg + i] << 4) |
                        ((uint32_t)s_hdr[2 * nseg + i] << 8);
    r[0] = (uint8_t)(sw & 0xFF);
    r[1] = (uint8_t)(sw >> 8);
    BitWriter wr{r + 2};
    const int32_t* ep = ep_hdr + (size_t)i * nf;
    for (int f = 0; f < nf; f++) wr.put((uint32_t)(ep[f] + 2048) & 0xFFF, 12);
    wr.flush();
  }
}

void limg_rt_unpack_headers(const uint8_t* recs, int64_t nseg, int ch,
                            int32_t* s_hdr /* (3, nseg) */,
                            int32_t* ep_hdr /* (nseg, 6ch) */) {
  const int nf = 6 * ch;
  const int rec = 2 + nf * 12 / 8;
  for (int64_t i = 0; i < nseg; i++) {
    const uint8_t* r = recs + (size_t)i * rec;
    const uint32_t sw = (uint32_t)r[0] | ((uint32_t)r[1] << 8);
    s_hdr[i] = (int32_t)(sw & 0xF);
    s_hdr[nseg + i] = (int32_t)((sw >> 4) & 0xF);
    s_hdr[2 * nseg + i] = (int32_t)((sw >> 8) & 0xF);
    BitReader rd{r + 2};
    int32_t* ep = ep_hdr + (size_t)i * nf;
    for (int f = 0; f < nf; f++) ep[f] = (int32_t)rd.get(12) - 2048;
  }
}

// Integer block decode (ops/decode.py semantics, see also
// bitstream._decode_blocks_np): per-block factors + shifts + endpoints ->
// packed (64, NB) RGBA words ready for limg_rt_unblockify_u32.
// q3: (3, NB, 64) u8; shifts: (3, NB) i32; eps: (6ch, NB) i32.
void limg_rt_decode_blocks(const uint8_t* q3, const int32_t* shifts,
                           const int32_t* eps, int64_t nb, int ch,
                           uint32_t* out_packed) {
  static const int32_t kMult[9] = {1, 2, 4, 8, 17, 36, 85, 255, 0};
  for (int64_t b = 0; b < nb; b++) {
    int32_t mins[3][4];
    int32_t normals[3][4];
    int32_t mult[3];
    for (int k = 0; k < 3; k++) {
      const int32_t s = shifts[k * nb + b];
      const bool dropped = s > 7;
      mult[k] = kMult[s < 8 ? s : 8];
      for (int c = 0; c < ch; c++) {
        const int32_t lo = eps[(2 * k + 0) * ch * nb + c * nb + b];
        const int32_t hi = eps[(2 * k + 1) * ch * nb + c * nb + b];
        normals[k][c] = dropped ? 0 : hi - lo;
        mins[k][c] = (dropped && k > 0) ? 0 : lo;
      }
    }
    const uint8_t* q0 = q3 + (size_t)b * 64;
    const uint8_t* q1 = q3 + (size_t)(nb + b) * 64;
    const uint8_t* q2 = q3 + (size_t)(2 * nb + b) * 64;
    for (int p = 0; p < 64; p++) {
      const int32_t f0 = q0[p] * mult[0];
      const int32_t f1 = q1[p] * mult[1];
      const int32_t f2 = q2[p] * mult[2];
      uint32_t word = ch == 3 ? 0xFF000000u : 0u;
      for (int c = 0; c < ch; c++) {
        int32_t acc = mins[0][c] + ((f0 * normals[0][c] + 128) >> 8);
        acc += mins[1][c] + ((f1 * normals[1][c] + 128) >> 8);
        acc += mins[2][c] + ((f2 * normals[2][c] + 128) >> 8);
        if (acc < 0) acc = 0;
        if (acc > 255) acc = 255;
        word |= (uint32_t)acc << (8 * c);
      }
      out_packed[(size_t)p * nb + b] = word;
    }
  }
}

}  // extern "C"
