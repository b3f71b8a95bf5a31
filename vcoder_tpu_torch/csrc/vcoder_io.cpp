// vcoder_io: native image decode + preprocess + prefetch pipeline.
//
// A copy of the JAX package's native/vcoder_io.cpp for the PyTorch port
// (vcoder_tpu_torch/native_io.py builds and binds it), with a second decode
// route. It provides:
//   * JPEG/PNG decode to RGB8: with libjpeg + libpng (the default build),
//     or, where those headers are missing, JPEG with nvJPEG from the CUDA
//     toolkit (-DVIO_NVJPEG); that build decodes no PNG (vio_decode
//     returns VIO_NOT_DECODED and the caller reads the PNG itself),
//   * pad-to-square with the CLIP-mean background (122,116,104) and
//     separable antialiased bicubic resize (PIL convention: Catmull-Rom
//     a=-0.5, filter support scaled by the downscale ratio),
//   * a multithreaded file->tensor pipeline with a bounded output queue.
//
// Host code with a C ABI consumed via ctypes.
// Build: g++ -O3 -shared -fPIC vcoder_io.cpp -o libvcoder_io.so -ljpeg -lpng -lpthread
//    or: nvcc -O3 -shared -Xcompiler -fPIC -DVIO_NVJPEG vcoder_io.cpp -o libvcoder_io.so -lnvjpeg

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#if defined(VIO_NVJPEG)
#include <cuda_runtime_api.h>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#include <png.h>
#include <csetjmp>
#endif

// vio_decode's code for bytes this build does not decode (a PNG in the
// nvJPEG build).
#define VIO_NOT_DECODED (-3)

extern "C" {

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

#if defined(VIO_NVJPEG)

static nvjpegHandle_t g_nvjpeg = nullptr;
static std::once_flag g_nvjpeg_once;
static int g_nvjpeg_status = 0;

// Decode JPEG bytes to RGB8 on the card with nvJPEG, then copy the pixels
// to the host. Returns 0 on success; *out is malloc'd.
static int decode_jpeg(const uint8_t* data, size_t len, uint8_t** out,
                       int* w, int* h) {
  std::call_once(g_nvjpeg_once, [] {
    g_nvjpeg_status = nvjpegCreateSimple(&g_nvjpeg) == NVJPEG_STATUS_SUCCESS ? 0 : -4;
  });
  if (g_nvjpeg_status != 0) return g_nvjpeg_status;
  int n_comp = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(g_nvjpeg, data, len, &n_comp, &subsampling, widths,
                         heights) != NVJPEG_STATUS_SUCCESS)
    return -1;
  const int W = widths[0], H = heights[0];
  const size_t bytes = static_cast<size_t>(W) * H * 3;
  nvjpegJpegState_t state = nullptr;
  if (nvjpegJpegStateCreate(g_nvjpeg, &state) != NVJPEG_STATUS_SUCCESS)
    return -1;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;
  uint8_t* buf = nullptr;
  int rc = -1;
  if (cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking) == cudaSuccess &&
      cudaMalloc(reinterpret_cast<void**>(&dev), bytes) == cudaSuccess) {
    nvjpegImage_t img;
    memset(&img, 0, sizeof img);
    img.channel[0] = dev;
    img.pitch[0] = static_cast<size_t>(W) * 3;
    buf = static_cast<uint8_t*>(malloc(bytes));
    if (buf &&
        nvjpegDecode(g_nvjpeg, state, data, len, NVJPEG_OUTPUT_RGBI, &img,
                     stream) == NVJPEG_STATUS_SUCCESS &&
        cudaMemcpyAsync(buf, dev, bytes, cudaMemcpyDeviceToHost, stream) ==
            cudaSuccess &&
        cudaStreamSynchronize(stream) == cudaSuccess)
      rc = 0;
  }
  if (dev) cudaFree(dev);
  if (stream) cudaStreamDestroy(stream);
  nvjpegJpegStateDestroy(state);
  if (rc != 0) {
    free(buf);
    return rc;
  }
  *w = W;
  *h = H;
  *out = buf;
  return 0;
}

static int decode_png(const uint8_t*, size_t, uint8_t**, int*, int*) {
  return VIO_NOT_DECODED;
}

#else

struct VioJpegErr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

static void vio_jpeg_error_exit(j_common_ptr cinfo) {
  VioJpegErr* err = reinterpret_cast<VioJpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

// Decode JPEG bytes to RGB8. Returns 0 on success; *out is malloc'd.
static int decode_jpeg(const uint8_t* data, size_t len, uint8_t** out,
                       int* w, int* h) {
  jpeg_decompress_struct cinfo;
  VioJpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = vio_jpeg_error_exit;
  uint8_t* buf = nullptr;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    free(buf);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  size_t stride = static_cast<size_t>(*w) * 3;
  buf = static_cast<uint8_t*>(malloc(stride * (*h)));
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buf;
  return 0;
}

static int decode_png(const uint8_t* data, size_t len, uint8_t** out,
                      int* w, int* h) {
  png_image image;
  memset(&image, 0, sizeof image);
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&image, data, len)) return -1;
  image.format = PNG_FORMAT_RGB;
  size_t stride = PNG_IMAGE_ROW_STRIDE(image);
  uint8_t* buf =
      static_cast<uint8_t*>(malloc(PNG_IMAGE_BUFFER_SIZE(image, stride)));
  if (!png_image_finish_read(&image, nullptr, buf, stride, nullptr)) {
    free(buf);
    png_image_free(&image);
    return -1;
  }
  *w = image.width;
  *h = image.height;
  *out = buf;
  return 0;
}

#endif  // VIO_NVJPEG

int vio_decode(const uint8_t* data, size_t len, uint8_t** out, int* w,
               int* h) {
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8)
    return decode_jpeg(data, len, out, w, h);
  if (len >= 8 && data[0] == 0x89 && data[1] == 'P' && data[2] == 'N' &&
      data[3] == 'G')
    return decode_png(data, len, out, w, h);
  // Try JPEG as a fallback (some .jpg files lack clean magic handling).
  return decode_jpeg(data, len, out, w, h);
}

void vio_free(uint8_t* p) { free(p); }

// ---------------------------------------------------------------------------
// Pad to square + bicubic resize (PIL convention)
// ---------------------------------------------------------------------------

static inline double bicubic_filter(double x) {
  // Catmull-Rom a = -0.5 (PIL BICUBIC)
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Precompute normalized filter taps for one resampled axis.
struct Taps {
  std::vector<int> bounds;   // [out_size * 2]: (start, count)
  std::vector<double> coef;  // [out_size * ksize]
  int ksize;
};

static Taps make_taps(int in_size, int out_size) {
  const double support = 2.0;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double supp = support * filterscale;
  int ksize = static_cast<int>(std::ceil(supp)) * 2 + 1;

  Taps t;
  t.ksize = ksize;
  t.bounds.resize(out_size * 2);
  t.coef.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(std::max(center - supp + 0.5, 0.0));
    int xmax =
        static_cast<int>(std::min(center + supp + 0.5,
                                  static_cast<double>(in_size)));
    double ss = 1.0 / filterscale;
    double wsum = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      double wv = bicubic_filter((x - center + 0.5) * ss);
      t.coef[static_cast<size_t>(xx) * ksize + (x - xmin)] = wv;
      wsum += wv;
    }
    if (wsum != 0.0) {
      for (int x = 0; x < xmax - xmin; ++x)
        t.coef[static_cast<size_t>(xx) * ksize + x] /= wsum;
    }
    t.bounds[xx * 2] = xmin;
    t.bounds[xx * 2 + 1] = xmax - xmin;
  }
  return t;
}

static inline uint8_t clip8(double v) {
  if (v <= 0.0) return 0;
  if (v >= 255.0) return 255;
  return static_cast<uint8_t>(v + 0.5);
}

// Resize RGB8 [h, w] -> [out, out] with separable bicubic.
static void resize_rgb(const uint8_t* src, int h, int w, int out_size,
                       uint8_t* dst) {
  if (h == out_size && w == out_size) {
    memcpy(dst, src, static_cast<size_t>(h) * w * 3);
    return;
  }
  Taps hx = make_taps(w, out_size);
  Taps vy = make_taps(h, out_size);

  // Horizontal pass: [h, out_size, 3] doubles.
  std::vector<double> tmp(static_cast<size_t>(h) * out_size * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    for (int xx = 0; xx < out_size; ++xx) {
      int xmin = hx.bounds[xx * 2], cnt = hx.bounds[xx * 2 + 1];
      const double* k = &hx.coef[static_cast<size_t>(xx) * hx.ksize];
      double acc[3] = {0, 0, 0};
      for (int i = 0; i < cnt; ++i) {
        const uint8_t* px = row + static_cast<size_t>(xmin + i) * 3;
        acc[0] += px[0] * k[i];
        acc[1] += px[1] * k[i];
        acc[2] += px[2] * k[i];
      }
      double* o = &tmp[(static_cast<size_t>(y) * out_size + xx) * 3];
      o[0] = acc[0];
      o[1] = acc[1];
      o[2] = acc[2];
    }
  }
  // Vertical pass -> uint8.
  for (int yy = 0; yy < out_size; ++yy) {
    int ymin = vy.bounds[yy * 2], cnt = vy.bounds[yy * 2 + 1];
    const double* k = &vy.coef[static_cast<size_t>(yy) * vy.ksize];
    for (int xx = 0; xx < out_size; ++xx) {
      double acc[3] = {0, 0, 0};
      for (int i = 0; i < cnt; ++i) {
        const double* px =
            &tmp[(static_cast<size_t>(ymin + i) * out_size + xx) * 3];
        acc[0] += px[0] * k[i];
        acc[1] += px[1] * k[i];
        acc[2] += px[2] * k[i];
      }
      uint8_t* o = dst + (static_cast<size_t>(yy) * out_size + xx) * 3;
      o[0] = clip8(acc[0]);
      o[1] = clip8(acc[1]);
      o[2] = clip8(acc[2]);
    }
  }
}

// Pad to centered square with background color, then resize.
void vio_pad_resize(const uint8_t* src, int h, int w, const uint8_t* bg,
                    int out_size, int do_pad, uint8_t* dst) {
  const uint8_t* input = src;
  std::vector<uint8_t> padded;
  int ih = h, iw = w;
  if (do_pad && h != w) {
    int side = std::max(h, w);
    padded.resize(static_cast<size_t>(side) * side * 3);
    for (size_t i = 0; i < padded.size(); i += 3) {
      padded[i] = bg[0];
      padded[i + 1] = bg[1];
      padded[i + 2] = bg[2];
    }
    int top = (side - h) / 2, left = (side - w) / 2;
    for (int y = 0; y < h; ++y) {
      memcpy(&padded[((static_cast<size_t>(top) + y) * side + left) * 3],
             src + static_cast<size_t>(y) * w * 3,
             static_cast<size_t>(w) * 3);
    }
    input = padded.data();
    ih = iw = side;
  }
  resize_rgb(input, ih, iw, out_size, dst);
}

// Decode a file from disk and preprocess in one call. Returns 0 on success.
int vio_load_file(const char* path, const uint8_t* bg, int out_size,
                  int do_pad, uint8_t* dst) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(len);
  if (fread(data.data(), 1, len, f) != static_cast<size_t>(len)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  uint8_t* rgb = nullptr;
  int w = 0, h = 0;
  int rc = vio_decode(data.data(), len, &rgb, &w, &h);
  if (rc != 0) return rc == VIO_NOT_DECODED ? VIO_NOT_DECODED : -2;
  vio_pad_resize(rgb, h, w, bg, out_size, do_pad, dst);
  free(rgb);
  return 0;
}

// ---------------------------------------------------------------------------
// Prefetch pipeline: worker threads turn file paths into preprocessed
// uint8 tensors, delivered through a bounded queue.
// ---------------------------------------------------------------------------

struct VioJob {
  long id;
  std::string path;
};

struct VioResult {
  long id;
  int status;
  std::vector<uint8_t> pixels;
};

struct VioPipeline {
  int out_size;
  int do_pad;
  uint8_t bg[3];
  std::deque<VioJob> jobs;
  std::deque<VioResult> results;
  std::mutex mu;
  std::condition_variable cv_jobs, cv_results;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      VioJob job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_jobs.wait(lk, [&] { return stop || !jobs.empty(); });
        if (stop && jobs.empty()) return;
        job = std::move(jobs.front());
        jobs.pop_front();
      }
      VioResult res;
      res.id = job.id;
      res.pixels.resize(static_cast<size_t>(out_size) * out_size * 3);
      res.status = vio_load_file(job.path.c_str(), bg, out_size, do_pad,
                                 res.pixels.data());
      {
        std::lock_guard<std::mutex> lk(mu);
        results.push_back(std::move(res));
      }
      cv_results.notify_one();
    }
  }
};

void* vio_pipeline_new(int n_threads, int out_size, int do_pad, uint8_t bg0,
                       uint8_t bg1, uint8_t bg2) {
  auto* p = new VioPipeline();
  p->out_size = out_size;
  p->do_pad = do_pad;
  p->bg[0] = bg0;
  p->bg[1] = bg1;
  p->bg[2] = bg2;
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

void vio_pipeline_submit(void* handle, long id, const char* path) {
  auto* p = static_cast<VioPipeline*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->jobs.push_back(VioJob{id, std::string(path)});
  }
  p->cv_jobs.notify_one();
}

// Blocks until one result is ready; writes pixels into dst
// (out_size*out_size*3 bytes). Returns the job id, or -1 on decode error
// for that id (id is still reported via *err_id).
long vio_pipeline_next(void* handle, uint8_t* dst, int* status) {
  auto* p = static_cast<VioPipeline*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_results.wait(lk, [&] { return !p->results.empty(); });
  VioResult res = std::move(p->results.front());
  p->results.pop_front();
  lk.unlock();
  *status = res.status;
  if (res.status == 0)
    memcpy(dst, res.pixels.data(), res.pixels.size());
  return res.id;
}

void vio_pipeline_free(void* handle) {
  auto* p = static_cast<VioPipeline*>(handle);
  p->stop = true;
  p->cv_jobs.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
