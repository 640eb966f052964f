// Multithreaded JPEG batch decoder for the host data pipeline.
//
// Native-runtime counterpart of the reference's DataLoader worker processes
// (reference train.py:98 num_workers + PIL decode): thousands of small JPEGs
// per training step must decode without Python/GIL overhead to keep the card
// fed. Plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Build: stylegan_v_tpu_torch/native/fastjpeg.py (g++ -O3 -shared -ljpeg), at first use.

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit_handler(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG buffer into out[H*W*C] (RGB or grayscale). Returns 0 on
// success, nonzero error code otherwise.
int decode_one(const uint8_t* data, size_t size, uint8_t* out, int H, int W,
               int C) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;  // corrupt stream
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = (C == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != H ||
      static_cast<int>(cinfo.output_width) != W ||
      static_cast<int>(cinfo.output_components) != C) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 2;  // unexpected dimensions
  }
  const size_t stride = static_cast<size_t>(W) * C;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

// Decode n JPEG buffers into a contiguous [n, H, W, C] uint8 array.
// Returns 0 on success; otherwise (index+1) of the first failing image.
int decode_jpeg_batch(const uint8_t** datas, const size_t* sizes, int n,
                      uint8_t* out, int H, int W, int C, int num_threads) {
  const size_t frame_bytes = static_cast<size_t>(H) * W * C;
  std::atomic<int> next(0);
  std::atomic<int> failed(0);

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n || failed.load() != 0) return;
      int rc = decode_one(datas[i], sizes[i], out + frame_bytes * i, H, W, C);
      if (rc != 0) failed.store(i + 1);
    }
  };

  int t = num_threads;
  if (t <= 0) t = static_cast<int>(std::thread::hardware_concurrency());
  if (t > n) t = n;
  if (t <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(t);
    for (int k = 0; k < t; ++k) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return failed.load();
}

// Probe dimensions of one JPEG: fills dims[3] = {H, W, C}; 0 on success.
int probe_jpeg(const uint8_t* data, size_t size, int* dims) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit_handler;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  jpeg_read_header(&cinfo, TRUE);
  dims[0] = static_cast<int>(cinfo.image_height);
  dims[1] = static_cast<int>(cinfo.image_width);
  dims[2] = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
