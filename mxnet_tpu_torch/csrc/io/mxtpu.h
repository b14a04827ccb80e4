/*
 * mxtpu.h — C ABI of the native runtime library.
 *
 * Role parity: the flat C ABI principle of the reference
 * (include/mxnet/c_api.h — the ONLY crossing between frontends and runtime,
 * SURVEY §1 L5). Scope in this build: the data-plane services where native
 * code matters on TPU hosts — RecordIO scanning (dmlc recordio format,
 * 3rdparty/dmlc-core), batch decode+augment assembly
 * (src/io/iter_image_recordio_2.cc role), and a threaded double-buffer
 * prefetch pump (src/io/iter_prefetcher.h role). All functions return 0 on
 * success, negative on error; mxtpu_last_error() gives the message
 * (MXGetLastError parity).
 */
#ifndef MXTPU_H_
#define MXTPU_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* error handling (c_api.h MXGetLastError parity) */
const char *mxtpu_last_error(void);

/* library introspection (libinfo.cc parity) */
int mxtpu_version(void);
int mxtpu_num_threads(void);

/* Cumulative count of records that failed decode and were zero-filled
 * (bad JPEG / corrupt container; parity with the reference parser's
 * skip-and-continue behavior). */
int64_t mxtpu_decode_failures(void);

/* ---- RecordIO ---------------------------------------------------------- */
/* Scan a dmlc-recordio file: fills offsets/lengths arrays (caller-allocated
 * with capacity `cap`); returns number of records or negative error. */
int64_t mxtpu_recordio_scan(const char *path, int64_t *offsets,
                            int64_t *lengths, int64_t cap);

/* Count records without filling arrays. */
int64_t mxtpu_recordio_count(const char *path);

/* ---- batch assembly ---------------------------------------------------- */
/* Decode + augment a batch of image records into a float32 NCHW buffer,
 * parallel across records (OpenMP). Record payloads are either JPEG
 * (reference ImageRecordIO format, decoded with libjpeg-turbo) or the
 * mxnet_tpu.recordio raw container:
 *   IRHeader(IfQQ) [label f32 array if flag>0] "MXTPURAW" u8:ndim
 *   i32[ndim] shape, u8 pixels (HWC).
 * resize > 0 resizes the shorter edge to `resize` (bilinear) before crop.
 * aug flags: bit0 = random mirror, bit1 = random crop (else center).
 * mean/std are per-channel (3). Returns 0 or negative error. */
int mxtpu_assemble_batch(const uint8_t *blob, const int64_t *offsets,
                         const int64_t *lengths, int n,
                         int c, int h, int w, int resize,
                         const float *mean, const float *std,
                         int aug_flags, uint64_t seed,
                         float *out_data, float *out_labels);

/* uint8 NHWC variant: decode + resize + crop + mirror only — normalize
 * and layout happen on-device (host→device link ships 4× fewer bytes). */
int mxtpu_assemble_batch_u8(const uint8_t *blob, const int64_t *offsets,
                            const int64_t *lengths, int n,
                            int c, int h, int w, int resize,
                            int aug_flags, uint64_t seed,
                            uint8_t *out_data, float *out_labels);

/* Augmentation-complete variants: random_h/s/l are HLS jitter ranges
 * (reference image_aug_default.cc random_h/random_s/random_l). */
int mxtpu_assemble_batch_aug(const uint8_t *blob, const int64_t *offsets,
                             const int64_t *lengths, int n, int c, int h,
                             int w, int resize, const float *mean,
                             const float *std_, int aug_flags,
                             uint64_t seed, int random_h, int random_s,
                             int random_l, float *out_data,
                             float *out_labels);
int mxtpu_assemble_batch_u8_aug(const uint8_t *blob, const int64_t *offsets,
                                const int64_t *lengths, int n, int c, int h,
                                int w, int resize, int aug_flags,
                                uint64_t seed, int random_h, int random_s,
                                int random_l, uint8_t *out_data,
                                float *out_labels);

/* ---- prefetch pump ----------------------------------------------------- */
/* Opaque double-buffered producer running on a native thread. The producer
 * repeatedly assembles batches from a record blob (above), cycling through
 * a shuffled epoch order. */
typedef void *mxtpu_pump_handle;

/* u8_mode != 0 → batches are uint8 NHWC (no normalize; mean/std ignored);
 * else float32 NCHW with normalize. */
mxtpu_pump_handle mxtpu_pump_create(const char *path, int batch_size,
                                    int c, int h, int w, int resize,
                                    int u8_mode,
                                    const float *mean, const float *std,
                                    int aug_flags, int shuffle,
                                    uint64_t seed, int depth);
/* Blocks until the next batch is ready; copies into out buffers
 * (out_data: float32 NCHW, or uint8 NHWC in u8 mode).
 * Returns 0, or 1 at epoch end (no batch copied), negative on error. */
int mxtpu_pump_next(mxtpu_pump_handle h, void *out_data, float *out_labels);
int mxtpu_pump_reset(mxtpu_pump_handle h);
int mxtpu_pump_batches_per_epoch(mxtpu_pump_handle h);
void mxtpu_pump_destroy(mxtpu_pump_handle h);

#ifdef __cplusplus
}
#endif

#endif  /* MXTPU_H_ */
