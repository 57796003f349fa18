// Host audio codecs of the PyTorch port: a FLAC decoder written from the
// format specification, and MP3 and Ogg/Vorbis read and written through
// the host's codec libraries (libmpg123, libmp3lame, libvorbisfile,
// libvorbis, libvorbisenc, libogg), opened with dlopen at first use so
// that the build needs no codec headers or link flags beyond -ldl.
//
// This is the port's own copy of the JAX package's native decoders, so
// both packages decode a file to the same samples. WAV reading and
// resampling stay in Python (data/audio.py).
//
// Built with g++ at first use (ops/kernels/build.py, load_host) and
// called through ctypes:
//   int la_read_flac(const char* path, float** out, int64* n, int* sr,
//                    int* ch, unsigned char md5[16])
//   int la_read_flac_int16(const char* path, int16** out, int64* n,
//                          int* sr, int* ch, unsigned char md5[16])
//   int la_read_mp3 (const char* path, float** out, int64* n, int* sr, int* ch)
//   int la_read_ogg (const char* path, float** out, int64* n, int* sr, int* ch)
//   int la_write_mp3(const char* path, const float* pcm, int64 n, int sr,
//                    int kbps)                  mono
//   int la_write_ogg(const char* path, const float* pcm, int64 n, int sr,
//                    float quality)             mono
//   int la_have_mp3(void), la_have_ogg(void)    1 when decode AND encode
//                                               libraries load
//   void la_free(float* p), la_free_i16(int16* p)
// Readers return interleaved frames ([n, ch]); every call returns 0 on
// success and a negative code otherwise (-20: the host has no library).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <ctime>
#include <vector>

#include <dlfcn.h>

extern "C" {

void la_free(float* p) { free(p); }

// ---------------------------------------------------------------------------
// FLAC
// ---------------------------------------------------------------------------

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed in current byte (0..7)
  bool fail = false;

  bool eof() const { return byte >= size; }

  uint32_t read_bits(int n) {  // n <= 32
    uint32_t v = 0;
    for (int i = 0; i < n; i++) {
      if (byte >= size) { fail = true; return 0; }
      v = (v << 1) | ((data[byte] >> (7 - bit)) & 1);
      if (++bit == 8) { bit = 0; byte++; }
    }
    return v;
  }

  uint64_t read_bits64(int n) {
    uint64_t v = 0;
    if (n > 32) { v = read_bits(n - 32); n = 32; }
    return (v << n) | read_bits(n);
  }

  int32_t read_signed(int n) {
    uint32_t v = read_bits(n);
    if (n == 0) return 0;
    if (v & (1u << (n - 1))) return (int32_t)(v | (~0u << n));
    return (int32_t)v;
  }

  uint32_t read_unary() {
    uint32_t q = 0;
    while (!fail) {
      if (byte >= size) { fail = true; return 0; }
      if ((data[byte] >> (7 - bit)) & 1) {
        if (++bit == 8) { bit = 0; byte++; }
        return q;
      }
      q++;
      if (++bit == 8) { bit = 0; byte++; }
    }
    return 0;
  }

  void align() {
    if (bit) { bit = 0; byte++; }
  }
};

int64_t read_utf8_coded(BitReader& br) {
  uint32_t b0 = br.read_bits(8);
  if (b0 < 0x80) return b0;
  int n = 0;
  for (uint32_t m = 0x80; b0 & m; m >>= 1) n++;
  if (n < 2 || n > 7) return -1;
  int64_t v = b0 & (0x7F >> n);
  for (int i = 1; i < n; i++) {
    uint32_t b = br.read_bits(8);
    if ((b & 0xC0) != 0x80) return -1;
    v = (v << 6) | (b & 0x3F);
  }
  return v;
}

bool decode_residual(BitReader& br, int blocksize, int pred_order,
                     std::vector<int64_t>& res) {
  uint32_t method = br.read_bits(2);
  if (method > 1) return false;
  int plen = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 15 : 31;
  uint32_t po = br.read_bits(4);
  uint32_t partitions = 1u << po;
  int idx = 0;
  for (uint32_t p = 0; p < partitions; p++) {
    int count = blocksize >> po;
    if (p == 0) count -= pred_order;
    if (count < 0) return false;
    uint32_t param = br.read_bits(plen);
    if (param == escape) {
      uint32_t raw = br.read_bits(5);
      for (int i = 0; i < count; i++) res[pred_order + idx++] = br.read_signed(raw);
    } else {
      for (int i = 0; i < count; i++) {
        uint64_t q = br.read_unary();
        uint64_t r = param ? br.read_bits(param) : 0;
        uint64_t u = (q << param) | r;
        res[pred_order + idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (br.fail) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
  if (br.read_bits(1) != 0) return false;  // padding
  uint32_t type = br.read_bits(6);
  int wasted = 0;
  if (br.read_bits(1)) wasted = br.read_unary() + 1;
  bps -= wasted;
  out.assign(blocksize, 0);

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; i++) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; i++) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED
    int order = type - 8;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    if (!decode_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; i++) {
      switch (order) {
        case 0: break;
        case 1: out[i] += out[i - 1]; break;
        case 2: out[i] += 2 * out[i - 1] - out[i - 2]; break;
        case 3: out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3]; break;
        case 4: out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] - out[i - 4]; break;
      }
    }
  } else if (type >= 32) {  // LPC
    int order = (type & 31) + 1;
    for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
    uint32_t prec = br.read_bits(4);
    if (prec == 15) return false;
    prec += 1;
    int shift = br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; i++) coef[i] = br.read_signed(prec);
    if (!decode_residual(br, blocksize, order, out)) return false;
    for (int i = order; i < blocksize; i++) {
      int64_t acc = 0;
      for (int j = 0; j < order; j++) acc += coef[j] * out[i - 1 - j];
      out[i] += acc >> shift;
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < blocksize; i++) out[i] <<= wasted;
  return !br.fail;
}

}  // namespace

int la_read_flac(const char* path, float** out, int64_t* n_out, int* sr_out,
                 int* ch_out, unsigned char md5_out[16]) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw(fsize);
  if (fread(raw.data(), 1, fsize, f) != (size_t)fsize) { fclose(f); return -2; }
  fclose(f);
  if (fsize < 42 || memcmp(raw.data(), "fLaC", 4)) return -3;

  size_t pos = 4;
  int sr = 0, channels = 0, bps = 0;
  uint64_t total_samples = 0;
  bool last = false;
  while (!last && pos + 4 <= raw.size()) {
    uint8_t hdr = raw[pos];
    last = hdr & 0x80;
    int type = hdr & 0x7F;
    uint32_t len = (raw[pos + 1] << 16) | (raw[pos + 2] << 8) | raw[pos + 3];
    pos += 4;
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* s = raw.data() + pos;
      sr = (s[10] << 12) | (s[11] << 4) | (s[12] >> 4);
      channels = ((s[12] >> 1) & 0x7) + 1;
      bps = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
      total_samples = ((uint64_t)(s[13] & 0xF) << 32) | ((uint64_t)s[14] << 24) |
                      (s[15] << 16) | (s[16] << 8) | s[17];
      if (md5_out) memcpy(md5_out, s + 18, 16);
    }
    pos += len;
  }
  if (!sr || !channels || bps < 4) return -4;

  std::vector<std::vector<int64_t>> ch(channels);
  std::vector<int64_t> pcm;  // interleaved
  pcm.reserve(total_samples * channels);

  BitReader br{raw.data(), raw.size()};
  br.byte = pos;

  while (br.byte + 2 < raw.size()) {
    // frame sync
    uint32_t sync = br.read_bits(14);
    if (br.fail) break;
    if (sync != 0x3FFE) return -5;
    br.read_bits(1);  // reserved
    br.read_bits(1);  // blocking strategy
    uint32_t bs_code = br.read_bits(4);
    uint32_t sr_code = br.read_bits(4);
    uint32_t ch_code = br.read_bits(4);
    uint32_t ss_code = br.read_bits(3);
    br.read_bits(1);  // reserved
    if (read_utf8_coded(br) < 0) return -6;

    int blocksize;
    switch (bs_code) {
      case 1: blocksize = 192; break;
      case 2: case 3: case 4: case 5:
        blocksize = 576 << (bs_code - 2); break;
      case 6: blocksize = br.read_bits(8) + 1; break;
      case 7: blocksize = br.read_bits(16) + 1; break;
      default: blocksize = 256 << (bs_code - 8); break;
    }
    if (sr_code == 12) br.read_bits(8);
    else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

    int frame_bps = bps;
    switch (ss_code) {
      case 1: frame_bps = 8; break;
      case 2: frame_bps = 12; break;
      case 4: frame_bps = 16; break;
      case 5: frame_bps = 20; break;
      case 6: frame_bps = 24; break;
      case 7: frame_bps = 32; break;
      default: break;  // 0 = from STREAMINFO
    }
    br.read_bits(8);  // CRC-8

    int nch = channels;
    if (ch_code <= 7) nch = ch_code + 1;
    else nch = 2;
    if (nch != channels) return -7;

    for (int c = 0; c < nch; c++) {
      int sub_bps = frame_bps;
      if ((ch_code == 8 && c == 1) || (ch_code == 9 && c == 0) ||
          (ch_code == 10 && c == 1))
        sub_bps += 1;  // side channel
      if (!decode_subframe(br, blocksize, sub_bps, ch[c])) return -8;
    }
    br.align();
    br.read_bits(16);  // frame CRC-16

    // inter-channel decorrelation
    if (ch_code == 8) {  // left/side
      for (int i = 0; i < blocksize; i++) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (ch_code == 9) {  // right/side
      for (int i = 0; i < blocksize; i++) ch[0][i] = ch[1][i] + ch[0][i];
    } else if (ch_code == 10) {  // mid/side
      for (int i = 0; i < blocksize; i++) {
        int64_t side = ch[1][i];
        int64_t mid = (ch[0][i] << 1) | (side & 1);
        ch[0][i] = (mid + side) >> 1;
        ch[1][i] = (mid - side) >> 1;
      }
    }
    for (int i = 0; i < blocksize; i++)
      for (int c = 0; c < channels; c++) pcm.push_back(ch[c][i]);
    if (total_samples && pcm.size() >= total_samples * channels) break;
  }

  int64_t frames = (int64_t)pcm.size() / channels;
  float* buf = (float*)malloc(pcm.size() * sizeof(float));
  float scale = 1.0f / (float)(1u << (bps - 1));
  for (size_t i = 0; i < pcm.size(); i++) buf[i] = pcm[i] * scale;
  *out = buf;
  *n_out = frames;
  *sr_out = sr;
  *ch_out = channels;
  return 0;
}

// raw int decode (for MD5 verification against STREAMINFO)
int la_read_flac_int16(const char* path, int16_t** out, int64_t* n_out,
                       int* sr_out, int* ch_out, unsigned char md5_out[16]) {
  float* fbuf;
  int64_t n;
  int sr, chn;
  int rc = la_read_flac(path, &fbuf, &n, &sr, &chn, md5_out);
  if (rc) return rc;
  int16_t* buf = (int16_t*)malloc(n * chn * sizeof(int16_t));
  for (int64_t i = 0; i < n * chn; i++) {
    float v = fbuf[i] * 32768.0f;
    buf[i] = (int16_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
  }
  free(fbuf);
  *out = buf;
  *n_out = n;
  *sr_out = sr;
  *ch_out = chn;
  return 0;
}

void la_free_i16(int16_t* p) { free(p); }

// ---------------------------------------------------------------------------
// MP3 (MPEG-1/2 Layer III) via the HOST codec library (libmpg123),
// bound at runtime with dlopen: compressed-audio decoding is the host
// codec's, everything downstream (resample, mel, framing) is the
// port's. dlopen keeps the build free of codec headers: a host without
// libmpg123 gets error -20 and the Python layer says so.
// ---------------------------------------------------------------------------

// mpg123 ABI constants (stable public API, checked against the host
// library at run time by the tests' encode/decode round trips)
static const int LA_MPG123_ENC_FLOAT_32 = 0x200;
static const int LA_MPG123_DONE = -12;
static const int LA_MPG123_NEW_FORMAT = -11;

// One loader per host codec library: each is the SINGLE place its
// soname fallback list appears — the read/write paths and the
// la_have_* probes (behind the Python have_mp3/have_ogg gates) all
// share it, so availability reporting cannot drift from what
// decode/encode actually dlopens.
static void* la_dl2(const char* a, const char* b, int flags) {
  void* d = dlopen(a, flags);
  return d ? d : dlopen(b, flags);
}
static void* la_dl_lame(void) {
  static void* dl = nullptr;
  static int tried = 0;
  if (!tried) {
    tried = 1;
    dl = la_dl2("libmp3lame.so.0", "libmp3lame.so", RTLD_NOW | RTLD_LOCAL);
  }
  return dl;
}
// vorbis libs load RTLD_GLOBAL: libvorbisfile/libvorbisenc resolve
// symbols from libvorbis/libogg at use time
static void* la_dl_vorbisfile(void) {
  static void* dl = nullptr;
  static int tried = 0;
  if (!tried) {
    tried = 1;
    dl = la_dl2("libvorbisfile.so.3", "libvorbisfile.so",
                RTLD_NOW | RTLD_GLOBAL);
  }
  return dl;
}
static void* la_dl_ogg(void) {
  static void* dl = nullptr;
  static int tried = 0;
  if (!tried) {
    tried = 1;
    dl = la_dl2("libogg.so.0", "libogg.so", RTLD_NOW | RTLD_GLOBAL);
  }
  return dl;
}
static void* la_dl_vorbis(void) {
  static void* dl = nullptr;
  static int tried = 0;
  if (!tried) {
    tried = 1;
    dl = la_dl2("libvorbis.so.0", "libvorbis.so", RTLD_NOW | RTLD_GLOBAL);
  }
  return dl;
}
static void* la_dl_vorbisenc(void) {
  static void* dl = nullptr;
  static int tried = 0;
  if (!tried) {
    tried = 1;
    dl = la_dl2("libvorbisenc.so.2", "libvorbisenc.so",
                RTLD_NOW | RTLD_GLOBAL);
  }
  return dl;
}

struct LaMpg123 {
  void* dl;
  int (*init_)(void);
  void* (*new_)(const char*, int*);
  int (*format_none_)(void*);
  int (*format_)(void*, long, int, int);
  int (*open_)(void*, const char*);
  int (*getformat_)(void*, long*, int*, int*);
  int (*read_)(void*, unsigned char*, size_t, size_t*);
  int (*close_)(void*);
  int (*delete_)(void*);
};

static LaMpg123* la_mpg123(void) {
  static LaMpg123 api;
  static int tried = 0;
  if (!tried) {
    tried = 1;
    api.dl = la_dl2("libmpg123.so.0", "libmpg123.so", RTLD_NOW | RTLD_LOCAL);
    if (api.dl) {
      api.init_ = (int (*)(void))dlsym(api.dl, "mpg123_init");
      api.new_ = (void* (*)(const char*, int*))dlsym(api.dl, "mpg123_new");
      api.format_none_ = (int (*)(void*))dlsym(api.dl, "mpg123_format_none");
      api.format_ = (int (*)(void*, long, int, int))dlsym(api.dl, "mpg123_format");
      api.open_ = (int (*)(void*, const char*))dlsym(api.dl, "mpg123_open");
      api.getformat_ =
          (int (*)(void*, long*, int*, int*))dlsym(api.dl, "mpg123_getformat");
      api.read_ = (int (*)(void*, unsigned char*, size_t, size_t*))dlsym(
          api.dl, "mpg123_read");
      api.close_ = (int (*)(void*))dlsym(api.dl, "mpg123_close");
      api.delete_ = (int (*)(void*))dlsym(api.dl, "mpg123_delete");
      if (api.init_ && api.new_ && api.format_none_ && api.format_ &&
          api.open_ && api.getformat_ && api.read_ && api.close_ &&
          api.delete_) {
        api.init_();
      } else {
        dlclose(api.dl);
        api.dl = nullptr;
      }
    }
  }
  return api.dl ? &api : nullptr;
}

int la_read_mp3(const char* path, float** out, int64_t* n_out, int* sr_out,
                int* ch_out) {
  LaMpg123* m = la_mpg123();
  if (!m) return -20;  // host has no libmpg123
  int err = 0;
  void* h = m->new_(nullptr, &err);
  if (!h) return -21;
  // force float32 output at every MPEG rate (mono or stereo = 3)
  m->format_none_(h);
  static const long kRates[] = {8000,  11025, 12000, 16000, 22050,
                                24000, 32000, 44100, 48000};
  for (long r : kRates) m->format_(h, r, 3, LA_MPG123_ENC_FLOAT_32);
  if (m->open_(h, path) != 0) {
    m->delete_(h);
    return -22;
  }
  long rate = 0;
  int ch = 0, enc = 0;
  if (m->getformat_(h, &rate, &ch, &enc) != 0 ||
      enc != LA_MPG123_ENC_FLOAT_32 || ch < 1) {
    m->close_(h);
    m->delete_(h);
    return -23;
  }
  std::vector<float> pcm;
  std::vector<unsigned char> buf(1 << 16);
  while (true) {
    size_t done = 0;
    int rc = m->read_(h, buf.data(), buf.size(), &done);
    if (done) {
      const float* f = (const float*)buf.data();
      pcm.insert(pcm.end(), f, f + done / sizeof(float));
    }
    if (rc == LA_MPG123_NEW_FORMAT) {
      // format (re)announcement: refresh rate/ch. A change AFTER pcm
      // has accumulated (concatenated VBR streams switching rate or
      // channel count) cannot be represented in one (sr, ch) result —
      // the already-decoded samples would be reinterpreted under the
      // new interleave/rate — so that case is a hard error, not a
      // silent refresh.
      long rate2 = rate;
      int ch2 = ch;
      if (m->getformat_(h, &rate2, &ch2, &enc) != 0 ||
          enc != LA_MPG123_ENC_FLOAT_32) {
        m->close_(h);
        m->delete_(h);
        return -24;
      }
      if (!pcm.empty() && (rate2 != rate || ch2 != ch)) {
        m->close_(h);
        m->delete_(h);
        return -26;  // mid-stream sr/ch change: unsupported
      }
      rate = rate2;
      ch = ch2;
      continue;
    }
    if (rc != 0) break;  // MPG123_DONE or error with no more data
  }
  m->close_(h);
  m->delete_(h);
  if (pcm.empty()) return -25;
  float* res = (float*)malloc(pcm.size() * sizeof(float));
  memcpy(res, pcm.data(), pcm.size() * sizeof(float));
  *out = res;
  *n_out = (int64_t)pcm.size() / ch;  // frames
  *sr_out = (int)rate;
  *ch_out = ch;
  return 0;
}

// mp3 ENCODER via the host's libmp3lame (dlopen, same pattern), for
// the tests and the smoke run to write their own files; mono, rounded
// to s16. Returns -20 when lame is absent.
int la_write_mp3(const char* path, const float* pcm, int64_t n, int sr,
                 int kbps) {
  void* dl = la_dl_lame();
  if (!dl) return -20;
  void* (*init)(void) = (void* (*)(void))dlsym(dl, "lame_init");
  int (*set_sr)(void*, int) = (int (*)(void*, int))dlsym(dl, "lame_set_in_samplerate");
  int (*set_ch)(void*, int) = (int (*)(void*, int))dlsym(dl, "lame_set_num_channels");
  int (*set_br)(void*, int) = (int (*)(void*, int))dlsym(dl, "lame_set_brate");
  int (*set_mode)(void*, int) = (int (*)(void*, int))dlsym(dl, "lame_set_mode");
  int (*init_params)(void*) = (int (*)(void*))dlsym(dl, "lame_init_params");
  int (*encode)(void*, const short*, const short*, int, unsigned char*, int) =
      (int (*)(void*, const short*, const short*, int, unsigned char*, int))
          dlsym(dl, "lame_encode_buffer");
  int (*flush)(void*, unsigned char*, int) =
      (int (*)(void*, unsigned char*, int))dlsym(dl, "lame_encode_flush");
  int (*close_)(void*) = (int (*)(void*))dlsym(dl, "lame_close");
  if (!init || !set_sr || !set_ch || !set_br || !set_mode || !init_params ||
      !encode || !flush || !close_)
    return -21;
  void* gf = init();
  if (!gf) return -22;
  set_sr(gf, sr);
  set_ch(gf, 1);
  set_br(gf, kbps > 0 ? kbps : 64);
  set_mode(gf, 3);  // MONO
  if (init_params(gf) < 0) {
    close_(gf);
    return -23;
  }
  std::vector<short> s16(n);
  for (int64_t i = 0; i < n; i++) {
    float v = pcm[i] * 32767.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    s16[i] = (short)lrintf(v);
  }
  FILE* f = fopen(path, "wb");
  if (!f) {
    close_(gf);
    return -24;
  }
  std::vector<unsigned char> obuf(((size_t)n * 5) / 4 + 7200);
  int64_t pos = 0;
  int rc = 0;
  while (pos < n) {
    int take = (int)((n - pos) < 65536 ? (n - pos) : 65536);
    int nb = encode(gf, s16.data() + pos, s16.data() + pos, take, obuf.data(),
                    (int)obuf.size());
    if (nb < 0) {
      rc = -25;
      break;
    }
    fwrite(obuf.data(), 1, nb, f);
    pos += take;
  }
  if (rc == 0) {
    int nb = flush(gf, obuf.data(), (int)obuf.size());
    if (nb > 0) fwrite(obuf.data(), 1, nb, f);
  }
  fclose(f);
  close_(gf);
  return rc;
}

// ---------------------------------------------------------------------------
// Ogg/Vorbis via the host's libvorbisfile (decode) and
// libvorbis/libvorbisenc/libogg (encode, for written test files), with
// the same dlopen pattern as mp3 above.
// ---------------------------------------------------------------------------

// vorbis_info's leading fields are stable public ABI (vorbis/codec.h)
struct LaVorbisInfo {
  int version;
  int channels;
  long rate;
  // ... (unused tail)
};

int la_read_ogg(const char* path, float** out, int64_t* n_out, int* sr_out,
                int* ch_out) {
  void* dl = la_dl_vorbisfile();
  if (!dl) return -20;
  int (*fopen_)(const char*, void*) =
      (int (*)(const char*, void*))dlsym(dl, "ov_fopen");
  LaVorbisInfo* (*info_)(void*, int) =
      (LaVorbisInfo * (*)(void*, int)) dlsym(dl, "ov_info");
  long (*read_float_)(void*, float***, int, int*) =
      (long (*)(void*, float***, int, int*))dlsym(dl, "ov_read_float");
  int (*clear_)(void*) = (int (*)(void*))dlsym(dl, "ov_clear");
  int (*raw_seek_)(void*, int64_t) =
      (int (*)(void*, int64_t))dlsym(dl, "ov_raw_seek");
  if (!fopen_ || !info_ || !read_float_ || !clear_) return -21;
  // OggVorbis_File is ~944 bytes; over-allocate for ABI headroom
  std::vector<unsigned char> vf(4096, 0);
  if (fopen_(path, vf.data()) != 0) return -22;
  // chained files: the open scan can leave the cursor at the LAST
  // link, silently dropping every earlier one — rewind to byte 0
  // (no-op for single-stream files)
  if (raw_seek_) raw_seek_(vf.data(), 0);
  LaVorbisInfo* vi = info_(vf.data(), -1);
  if (!vi || vi->channels < 1) {
    clear_(vf.data());
    return -23;
  }
  int ch = vi->channels;
  long rate = vi->rate;
  std::vector<float> pcm;  // interleaved
  int bitstream = 0;
  int cur_link = -1;
  while (true) {
    float** chans = nullptr;
    long got = read_float_(vf.data(), &chans, 4096, &bitstream);
    if (got <= 0) break;  // 0 = EOF; negative = hole/error -> stop
    if (bitstream != cur_link) {
      // chained ogg (concatenated logical bitstreams): the channel
      // count / rate may change per link — deinterleaving with the
      // initial ch would read past chans[], and a rate change would
      // mislabel the PCM. Match la_read_mp3's contract: refuse.
      LaVorbisInfo* li = info_(vf.data(), bitstream);
      if (!li || li->channels != ch || li->rate != rate) {
        clear_(vf.data());
        return -26;  // mid-stream sr/ch change: unsupported
      }
      cur_link = bitstream;
    }
    size_t base = pcm.size();
    pcm.resize(base + (size_t)got * ch);
    for (long s = 0; s < got; s++)
      for (int c = 0; c < ch; c++)
        pcm[base + (size_t)s * ch + c] = chans[c][s];
  }
  clear_(vf.data());
  if (pcm.empty()) return -25;
  float* res = (float*)malloc(pcm.size() * sizeof(float));
  memcpy(res, pcm.data(), pcm.size() * sizeof(float));
  *out = res;
  *n_out = (int64_t)pcm.size() / ch;
  *sr_out = (int)rate;
  *ch_out = ch;
  return 0;
}

// minimal mono Vorbis encoder (test files):
// the canonical libvorbis encode flow — analysis init, 3 header
// packets, blockwise analysis, ogg page-out. Opaque codec structs are
// over-allocated zeroed buffers; ogg_packet/ogg_page are small public
// POD structs mirrored locally.
struct LaOggPacket {
  unsigned char* packet;
  long bytes;
  long b_o_s;
  long e_o_s;
  int64_t granulepos;
  int64_t packetno;
};
struct LaOggPage {
  unsigned char* header;
  long header_len;
  unsigned char* body;
  long body_len;
};

int la_write_ogg(const char* path, const float* pcm, int64_t n, int sr,
                 float quality) {
  void* dlo = la_dl_ogg();
  void* dlv = la_dl_vorbis();
  void* dle = la_dl_vorbisenc();
  if (!dlv || !dle || !dlo) return -20;
  void (*vi_init)(void*) = (void (*)(void*))dlsym(dlv, "vorbis_info_init");
  int (*enc_init)(void*, long, long, float) =
      (int (*)(void*, long, long, float))dlsym(dle, "vorbis_encode_init_vbr");
  int (*an_init)(void*, void*) =
      (int (*)(void*, void*))dlsym(dlv, "vorbis_analysis_init");
  int (*blk_init)(void*, void*) =
      (int (*)(void*, void*))dlsym(dlv, "vorbis_block_init");
  void (*comment_init)(void*) = (void (*)(void*))dlsym(dlv, "vorbis_comment_init");
  int (*headerout)(void*, void*, void*, void*, void*) =
      (int (*)(void*, void*, void*, void*, void*))dlsym(
          dlv, "vorbis_analysis_headerout");
  float** (*buffer)(void*, int) =
      (float** (*)(void*, int))dlsym(dlv, "vorbis_analysis_buffer");
  int (*wrote)(void*, int) = (int (*)(void*, int))dlsym(dlv, "vorbis_analysis_wrote");
  int (*blockout)(void*, void*) =
      (int (*)(void*, void*))dlsym(dlv, "vorbis_analysis_blockout");
  int (*analysis)(void*, void*) = (int (*)(void*, void*))dlsym(dlv, "vorbis_analysis");
  int (*addblock)(void*) = (int (*)(void*))dlsym(dlv, "vorbis_bitrate_addblock");
  int (*flushpacket)(void*, void*) =
      (int (*)(void*, void*))dlsym(dlv, "vorbis_bitrate_flushpacket");
  void (*block_clear)(void*) = (void (*)(void*))dlsym(dlv, "vorbis_block_clear");
  void (*dsp_clear)(void*) = (void (*)(void*))dlsym(dlv, "vorbis_dsp_clear");
  void (*comment_clear)(void*) = (void (*)(void*))dlsym(dlv, "vorbis_comment_clear");
  void (*info_clear)(void*) = (void (*)(void*))dlsym(dlv, "vorbis_info_clear");
  int (*os_init)(void*, int) = (int (*)(void*, int))dlsym(dlo, "ogg_stream_init");
  int (*os_packetin)(void*, void*) =
      (int (*)(void*, void*))dlsym(dlo, "ogg_stream_packetin");
  int (*os_pageout)(void*, void*) =
      (int (*)(void*, void*))dlsym(dlo, "ogg_stream_pageout");
  int (*os_flush)(void*, void*) = (int (*)(void*, void*))dlsym(dlo, "ogg_stream_flush");
  int (*os_clear)(void*) = (int (*)(void*))dlsym(dlo, "ogg_stream_clear");
  if (!vi_init || !enc_init || !an_init || !blk_init || !comment_init ||
      !headerout || !buffer || !wrote || !blockout || !analysis ||
      !addblock || !flushpacket || !block_clear || !dsp_clear ||
      !comment_clear || !info_clear || !os_init || !os_packetin ||
      !os_pageout || !os_flush || !os_clear)
    return -21;

  // open the output BEFORE initializing any codec state, so the
  // unwritable-path failure leaks nothing (batch converts over
  // read-only trees hit this per file)
  FILE* f = fopen(path, "wb");
  if (!f) return -24;

  std::vector<unsigned char> vi(8192, 0), vd(8192, 0), vb(8192, 0),
      vc(8192, 0), os(8192, 0);
  vi_init(vi.data());
  if (enc_init(vi.data(), 1, sr, quality) != 0) {
    info_clear(vi.data());
    fclose(f);
    return -22;
  }
  comment_init(vc.data());
  an_init(vd.data(), vi.data());
  blk_init(vd.data(), vb.data());
  // unique-ish serial per encode: the Ogg spec requires DISTINCT
  // serial numbers for the links of a chained stream — with a fixed
  // serial, `cat a.ogg b.ogg` produces an invalid chain that decoders
  // stop reading at the first link's EOF
  static int serial = 0;
  if (serial == 0) serial = (int)(time(nullptr) & 0x3fffffff) + 1;
  os_init(os.data(), serial++);
  LaOggPacket hdr, hdr_comm, hdr_code;
  headerout(vd.data(), vc.data(), &hdr, &hdr_comm, &hdr_code);
  os_packetin(os.data(), &hdr);
  os_packetin(os.data(), &hdr_comm);
  os_packetin(os.data(), &hdr_code);
  LaOggPage pg;
  while (os_flush(os.data(), &pg) != 0) {
    fwrite(pg.header, 1, pg.header_len, f);
    fwrite(pg.body, 1, pg.body_len, f);
  }
  int64_t pos = 0;
  bool eos = false;
  while (!eos) {
    long take = (long)((n - pos) < 1024 ? (n - pos) : 1024);
    if (take > 0) {
      float** buf = buffer(vd.data(), (int)take);
      memcpy(buf[0], pcm + pos, take * sizeof(float));
      pos += take;
    }
    wrote(vd.data(), (int)take);  // 0 signals end of stream
    while (blockout(vd.data(), vb.data()) == 1) {
      analysis(vb.data(), nullptr);
      addblock(vb.data());
      LaOggPacket op;
      while (flushpacket(vd.data(), &op) == 1) {
        os_packetin(os.data(), &op);
        while (os_pageout(os.data(), &pg) != 0) {
          fwrite(pg.header, 1, pg.header_len, f);
          fwrite(pg.body, 1, pg.body_len, f);
        }
      }
    }
    if (take == 0) {
      while (os_flush(os.data(), &pg) != 0) {
        fwrite(pg.header, 1, pg.header_len, f);
        fwrite(pg.body, 1, pg.body_len, f);
      }
      eos = true;
    }
  }
  fclose(f);
  os_clear(os.data());
  block_clear(vb.data());
  dsp_clear(vd.data());
  comment_clear(vc.data());
  info_clear(vi.data());
  return 0;
}

// Codec availability probes — the truth source for the Python
// have_mp3/have_ogg gates: they exercise the exact loaders the
// read/write paths use (decode AND encode, since fixture synthesis
// writes before it reads).
int la_have_mp3(void) {
  return (la_mpg123() != nullptr && la_dl_lame() != nullptr) ? 1 : 0;
}

int la_have_ogg(void) {
  return (la_dl_vorbisfile() != nullptr && la_dl_ogg() != nullptr &&
          la_dl_vorbis() != nullptr && la_dl_vorbisenc() != nullptr)
             ? 1
             : 0;
}

}  // extern "C"
