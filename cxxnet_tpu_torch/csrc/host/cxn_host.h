/*!
 * cxn_host.h — the plain C interface of the port's host library.
 *
 * The host library holds the input pipeline's native pieces: the JPEG
 * decoder (jpeg_decode.cc), the binary PPM/PGM decoder (pnm_decode.cc), the
 * geometric augmenter's warp (warp_affine.cc) and the BinaryPage read-ahead
 * reader (page_reader.cc). It needs no CUDA and no outside library: it is
 * built with g++ at first use (cxxnet_tpu_torch/utils/native.py).
 *
 * No call keeps global state, so every call is safe from any number of
 * threads at once; ctypes releases the GIL around each.
 */
#ifndef CXN_HOST_H_
#define CXN_HOST_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Status codes of the decoders. CXN_OK is success; CXN_CORRUPT means the
 * bytes are not a decodable stream; the CXN_REFUSED_* codes name a valid
 * stream in a form this decoder does not implement. */
enum {
  CXN_OK = 0,
  CXN_CORRUPT = 1,
  CXN_REFUSED_ARITHMETIC = 2,   /* arithmetic coding (SOF9-SOF11) */
  CXN_REFUSED_PRECISION = 3,    /* a sample precision other than 8 bits */
  CXN_REFUSED_LOSSLESS = 4,     /* lossless or hierarchical (SOF3, SOF5-7,
                                   SOF13-15) */
  CXN_REFUSED_CMYK = 5,         /* four components (CMYK / YCCK) */
  CXN_REFUSED_SAMPLING = 6,     /* a chroma layout other than 4:4:4, 4:2:2,
                                   4:2:0, 4:4:0 and 4:1:1 */
  CXN_REFUSED_COMPONENTS = 7,   /* a component count other than 1, 3, 4 */
  CXN_REFUSED_SMOOTHING = 8,    /* a progressive stream that ends before
                                   its last refinement (libjpeg smooths its
                                   blocks) */
  CXN_REFUSED_MAXVAL = 9        /* PNM with a maxval other than 255 */
};

/* JPEG: the image's height and width from its frame header. */
int cxn_jpeg_dims(const uint8_t *buf, int64_t size, int64_t *h, int64_t *w,
                  char *msg, int64_t msg_len);

/* JPEG: decode into caller-allocated float32 CHW RGB planes
 * (out[c * h * w + y * w + x], values 0..255), h and w from
 * cxn_jpeg_dims. */
int cxn_jpeg_decode_f32(const uint8_t *buf, int64_t size, float *out,
                        int64_t h, int64_t w, char *msg, int64_t msg_len);

/* Binary PPM (P6) / PGM (P5): header fields. */
int cxn_pnm_dims(const uint8_t *buf, int64_t size, int64_t *h, int64_t *w,
                 char *msg, int64_t msg_len);

/* Binary PPM / PGM with maxval 255 into float32 CHW RGB planes (gray
 * replicated to three planes). */
int cxn_pnm_decode_f32(const uint8_t *buf, int64_t size, float *out,
                       int64_t h, int64_t w, char *msg, int64_t msg_len);

/* Bicubic affine warp of an HWC uint8 image with a constant border.
 * inv holds the float32 inverse map [a b c; d e f]: output pixel (x, y)
 * samples the source at (a*x + (b*y + c), d*x + (e*y + f)). */
void cxn_warp_affine_u8(const uint8_t *src, int64_t h, int64_t w, int64_t c,
                        const float *inv, uint8_t *dst, int64_t out_h,
                        int64_t out_w, int fill);

/* BinaryPage read-ahead over a chain of .bin files. */
void *cxn_page_reader_create(const char *const *paths, int64_t npath,
                             int64_t page_ints, int64_t lookahead);
void cxn_page_reader_before_first(void *handle);
/* The next object's size, its bytes at *out (valid until the next call);
 * -1 at the end of the chain, -2 on a read or page-layout error. */
int64_t cxn_page_reader_next(void *handle, const void **out);
void cxn_page_reader_free(void *handle);

#ifdef __cplusplus
}
#endif

#endif  // CXN_HOST_H_
