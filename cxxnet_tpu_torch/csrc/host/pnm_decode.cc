/*!
 * pnm_decode.cc — binary PPM (P6) and PGM (P5) records with maxval 255 to
 * float32 CHW RGB, header and conversion off the GIL.
 *
 * The header is read as cxxnet_tpu_torch/io/iter_image.py _pnm_header
 * reads it (whitespace, comments to the end of the line, three decimal
 * fields, one whitespace byte), and a gray image is replicated to three
 * planes, so the output is bit for bit that of the numpy _decode_pnm.
 */
#include "cxn_host.h"

#include <cstdio>
#include <cstring>

namespace {

bool is_space(int c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == 0x0b ||
         c == 0x0c;
}

void put_msg(char *msg, int64_t len, const char *what) {
  if (msg != nullptr && len > 0) std::snprintf(msg, size_t(len), "%s", what);
}

struct Header {
  int channels;
  int64_t w, h, maxval, off;
};

int parse(const uint8_t *buf, int64_t n, Header *hd, char *msg,
          int64_t msg_len) {
  if (n < 2 || buf[0] != 'P' || (buf[1] != '5' && buf[1] != '6')) {
    put_msg(msg, msg_len, "not a binary PPM/PGM record");
    return CXN_CORRUPT;
  }
  int64_t fields[3];
  int nf = 0;
  int64_t i = 2;
  while (nf < 3) {
    while (i < n && is_space(buf[i])) ++i;
    if (i < n && buf[i] == '#') {
      while (i < n && buf[i] != '\n' && buf[i] != '\r') ++i;
      continue;
    }
    int64_t j = i, v = 0;
    while (j < n && buf[j] >= '0' && buf[j] <= '9') {
      // a field past 2^40 is no image this reader could hold
      if (v < (int64_t(1) << 40)) v = v * 10 + (buf[j] - '0');
      ++j;
    }
    if (j == i) {
      put_msg(msg, msg_len, "malformed PNM header");
      return CXN_CORRUPT;
    }
    fields[nf++] = v;
    i = j;
  }
  if (i >= n || !is_space(buf[i])) {
    put_msg(msg, msg_len, "malformed PNM header");
    return CXN_CORRUPT;
  }
  hd->channels = buf[1] == '6' ? 3 : 1;
  hd->w = fields[0];
  hd->h = fields[1];
  hd->maxval = fields[2];
  hd->off = i + 1;
  if (hd->maxval != 255) {
    put_msg(msg, msg_len, "PNM maxval other than 255");
    return CXN_REFUSED_MAXVAL;
  }
  if (hd->w <= 0 || hd->h <= 0 ||
      n - hd->off < hd->w * hd->h * hd->channels) {
    char b[160];
    std::snprintf(b, sizeof(b),
                  "truncated PNM record (%lldx%lldx%d, %lld bytes)",
                  (long long)hd->w, (long long)hd->h, hd->channels,
                  (long long)n);
    put_msg(msg, msg_len, b);
    return CXN_CORRUPT;
  }
  return CXN_OK;
}

}  // namespace

extern "C" int cxn_pnm_dims(const uint8_t *buf, int64_t size, int64_t *h,
                            int64_t *w, char *msg, int64_t msg_len) {
  Header hd;
  int rc = parse(buf, size, &hd, msg, msg_len);
  if (rc == CXN_OK) {
    *h = hd.h;
    *w = hd.w;
  }
  return rc;
}

extern "C" int cxn_pnm_decode_f32(const uint8_t *buf, int64_t size,
                                  float *out, int64_t h, int64_t w,
                                  char *msg, int64_t msg_len) {
  Header hd;
  int rc = parse(buf, size, &hd, msg, msg_len);
  if (rc != CXN_OK) return rc;
  if (hd.h != h || hd.w != w) {
    put_msg(msg, msg_len, "dimensions differ from the header's");
    return CXN_CORRUPT;
  }
  const uint8_t *pix = buf + hd.off;
  const int64_t plane = h * w;
  if (hd.channels == 1) {
    for (int64_t i = 0; i < plane; ++i) {
      float v = float(pix[i]);
      out[i] = v;
      out[plane + i] = v;
      out[2 * plane + i] = v;
    }
  } else {
    for (int64_t i = 0; i < plane; ++i) {
      out[i] = float(pix[3 * i]);
      out[plane + i] = float(pix[3 * i + 1]);
      out[2 * plane + i] = float(pix[3 * i + 2]);
    }
  }
  return CXN_OK;
}
