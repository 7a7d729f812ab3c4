// Native JPEG -> padded BGR uint8 decoder for the multi-view loader.
//
// Replaces the PIL route's decode -> numpy conversion -> BGR flip copy ->
// pad copy -> stack copy chain with ONE pass: libjpeg-turbo decodes each
// scanline directly into the caller's pre-zeroed padded [out_h, out_w, 3]
// slot in BGR order (JCS_EXT_BGR), so padding, channel order and the
// batch stack all materialize for free.  The reference's data loader
// leans on cv2's native decoder the same way (mmcv.imread); this is the
// TPU build's equivalent native data-path component (SURVEY §2.4).
//
// Thread-safe (one jpeg_decompress_struct per call, no globals): the
// loader's worker threads decode concurrently while Python holds no GIL
// around the ctypes call.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstring>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

void emit_nothing(j_common_ptr, int) {}

}  // namespace

extern "C" {

// Decode one JPEG into out[out_h, out_w, 3] uint8 BGR (row-major, C
// contiguous).  The image's rows land at out[0:h, 0:w, :]; the caller
// pre-zeroes the buffer so the right/bottom pad stays 0.  Returns 0 on
// success; 1 = corrupt stream, 2 = bad header, 3 = image larger than the
// padded buffer or not 3-channel-decodable.
int jpeg_decode_bgr(const unsigned char* data, unsigned long len,
                    unsigned char* out, int out_h, int out_w,
                    int* got_h, int* got_w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  jerr.pub.emit_message = emit_nothing;   // no stderr spam from workers
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  // grayscale sources upconvert; color sources decode straight to BGR
  cinfo.out_color_space =
      (cinfo.jpeg_color_space == JCS_GRAYSCALE) ? JCS_GRAYSCALE
                                                : JCS_EXT_BGR;
  jpeg_start_decompress(&cinfo);
  const int h = static_cast<int>(cinfo.output_height);
  const int w = static_cast<int>(cinfo.output_width);
  const int comps = cinfo.output_components;
  if (h > out_h || w > out_w || (comps != 3 && comps != 1) ||
      (comps == 1 && w > 8192)) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  *got_h = h;
  *got_w = w;
  const long row_stride = static_cast<long>(out_w) * 3;
  if (comps == 3) {
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW row = out + static_cast<long>(cinfo.output_scanline)
                         * row_stride;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
  } else {  // grayscale: decode a line, then replicate into B=G=R
    // stack buffer: camera JPEGs are <= 8K wide in practice
    unsigned char line[8192];
    while (cinfo.output_scanline < cinfo.output_height) {
      JSAMPROW row = line;
      long y = cinfo.output_scanline;
      jpeg_read_scanlines(&cinfo, &row, 1);
      unsigned char* dst = out + y * row_stride;
      for (int x = 0; x < w; ++x) {
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = line[x];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
