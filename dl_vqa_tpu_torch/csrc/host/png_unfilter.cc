// PNG's five row filters undone on the host, for the PNG reader of the
// "exact" decoder (data/image_formats.py; zlib from Python's standard
// library inflates the IDAT data first). A Paeth pass in Python would
// take seconds for one photograph.
//
//   vqa_torch_png_unfilter(data, len, rows, row_bytes, bpp, out)
//     data: rows * (1 + row_bytes) bytes, each row its filter type then its
//     filtered bytes (one image, or one pass of an Adam7 image); bpp: the
//     bytes of a whole pixel, at least 1; out: rows * row_bytes bytes.
//     -> 0 ok, 1 a filter type above 4, 2 fewer bytes than the rows need.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

int vqa_torch_png_unfilter(const uint8_t* data, size_t len, int rows,
                           size_t row_bytes, int bpp, uint8_t* out) {
  if (len < size_t(rows) * (row_bytes + 1)) return 2;
  const uint8_t* prev = nullptr;  // the row above, reconstructed
  for (int y = 0; y < rows; ++y) {
    const uint8_t* in = data + size_t(y) * (row_bytes + 1);
    uint8_t* cur = out + size_t(y) * row_bytes;
    const int filter = in[0];
    ++in;
    switch (filter) {
      case 0:
        std::memcpy(cur, in, row_bytes);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < row_bytes; ++i)
          cur[i] = uint8_t(in[i] + (i >= size_t(bpp) ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (size_t i = 0; i < row_bytes; ++i)
          cur[i] = uint8_t(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (size_t i = 0; i < row_bytes; ++i) {
          const int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = uint8_t(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < row_bytes; ++i) {
          const int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = prev && i >= size_t(bpp) ? prev[i - bpp] : 0;
          const int pa = std::abs(b - c), pb = std::abs(a - c),
                    pc = std::abs(a + b - 2 * c);
          cur[i] = uint8_t(in[i] + (pa <= pb && pa <= pc ? a
                                    : pb <= pc           ? b
                                                         : c));
        }
        break;
      default:
        return 1;
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
