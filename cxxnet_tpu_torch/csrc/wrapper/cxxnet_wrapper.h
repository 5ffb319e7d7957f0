/*!
 * cxxnet_wrapper.h — handle-based C ABI of cxxnet_tpu_torch, the PyTorch
 * port. The declarations are those of wrapper/cxxnet_wrapper.h, so a
 * program written against that header (wrapper/test_wrapper.c) builds
 * against this library unchanged.
 *
 * Iterator and net handles are created from config strings; update from an
 * iterator or raw row-major float batches; predict/extract return borrowed
 * float buffers (valid until the next call on the same handle); evaluate
 * returns a string; weights get/set.
 *
 * The library embeds a CPython interpreter and drives cxxnet_tpu_torch.api.
 * Environment knob read at first call:
 *   CXXNET_TPU_ROOT   checkout root to put on sys.path (default: the
 *                     checkout the library was built from)
 * CXNNetCreate takes "cpu" (the host) or "gpu" (the card; NULL when the
 * machine has none).
 *
 * All functions return NULL / a negative count on error; the message is
 * printed to stderr and retrievable via CXNGetLastError().
 */
#ifndef CXXNET_WRAPPER_H_
#define CXXNET_WRAPPER_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef float cxn_real_t;
typedef uint32_t cxn_uint;

const char *CXNGetLastError(void);

/* ---- data iterator ---- */
void *CXNIOCreateFromConfig(const char *cfg);
/*! move to next batch; 1 = has batch, 0 = end of epoch, -1 = error */
int CXNIONext(void *handle);
int CXNIOBeforeFirst(void *handle);
/*! current batch data; writes the 4-D shape; buffer lives until next call */
const cxn_real_t *CXNIOGetData(void *handle, cxn_uint oshape[4]);
/*! current batch labels; writes (batch, label_width) */
const cxn_real_t *CXNIOGetLabel(void *handle, cxn_uint oshape[2]);
void CXNIOFree(void *handle);

/* ---- net ---- */
void *CXNNetCreate(const char *device, const char *cfg);
void CXNNetFree(void *handle);
int CXNNetSetParam(void *handle, const char *name, const char *val);
int CXNNetInitModel(void *handle);
int CXNNetSaveModel(void *handle, const char *fname);
int CXNNetLoadModel(void *handle, const char *fname);
int CXNNetStartRound(void *handle, int round_counter);
/*! one update step on the iterator's current batch */
int CXNNetUpdateIter(void *net_handle, void *io_handle);
/*! one update step on a raw batch: data is row-major (dshape), labels
 *  (lshape[0], lshape[1]); label may be NULL for unlabeled nets */
int CXNNetUpdateBatch(void *handle, const cxn_real_t *data,
                      const cxn_uint dshape[4], const cxn_real_t *label,
                      const cxn_uint lshape[2]);
/*! per-row predictions; *out_size rows; buffer lives until next call */
const cxn_real_t *CXNNetPredictBatch(void *handle, const cxn_real_t *data,
                                     const cxn_uint dshape[4],
                                     cxn_uint *out_size);
const cxn_real_t *CXNNetPredictIter(void *net_handle, void *io_handle,
                                    cxn_uint *out_size);
/*! named-node activations flattened to (batch, feat); writes both dims */
const cxn_real_t *CXNNetExtractBatch(void *handle, const cxn_real_t *data,
                                     const cxn_uint dshape[4],
                                     const char *node_name,
                                     cxn_uint oshape[2]);
const cxn_real_t *CXNNetExtractIter(void *net_handle, void *io_handle,
                                    const char *node_name,
                                    cxn_uint oshape[2]);
/*! KV-cached generation for sequence nets (beyond the reference ABI —
 *  the serving loop of Trainer.generate): ``prompts`` is a row-major
 *  (batch, prompt_len) matrix of token ids encoded as floats; returns a
 *  borrowed (batch, n_new) matrix of generated ids (float-encoded,
 *  exact for vocabularies < 2^24) and fills oshape. Greedy when
 *  temperature == 0; temperature/top_k/seed select sampling. */
const cxn_real_t *CXNNetGenerate(void *handle, const cxn_real_t *prompts,
                                 const cxn_uint pshape[2], cxn_uint n_new,
                                 float temperature, cxn_uint top_k,
                                 cxn_uint seed, cxn_uint oshape[2]);
/*! run metrics over an eval iterator; string lives until next call */
const char *CXNNetEvaluate(void *net_handle, void *io_handle,
                           const char *data_name);
int CXNNetSetWeight(void *handle, const cxn_real_t *weight,
                    const cxn_uint wshape[2], const char *layer_name,
                    const char *tag);
/*! weight as 2-D (out, in-flat); writes the dims */
const cxn_real_t *CXNNetGetWeight(void *handle, const char *layer_name,
                                  const char *tag, cxn_uint oshape[2]);

#ifdef __cplusplus
}
#endif
#endif /* CXXNET_WRAPPER_H_ */
