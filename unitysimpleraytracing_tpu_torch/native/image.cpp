// Native image-IO hot loops (PNG scanline unfiltering).
//
// The Python fallback in io/png.py runs per-byte loops for the Sub/Average/
// Paeth filters (PNG spec §6); this is the C++ fast path, loaded via ctypes
// next to the OBJ ingester (see native/__init__.py).  8-bit samples only —
// the only depth the framework reads (matches the reference's viking_room
// texture asset).

extern "C" {

// raw: h * (1 + stride) filtered bytes (each row: filter-type byte + data).
// out: h * stride unfiltered bytes.  bpp = bytes per pixel (= channels at
// bit depth 8).  Returns 0 on success, 1 + row on an unknown filter type.
long png_unfilter(const unsigned char* raw, long h, long stride, long bpp,
                  unsigned char* out) {
    const unsigned char* prev = nullptr;
    for (long row = 0; row < h; ++row) {
        const unsigned char* src = raw + row * (stride + 1);
        unsigned char* dst = out + row * stride;
        const unsigned char ftype = src[0];
        ++src;
        switch (ftype) {
            case 0:  // None
                for (long i = 0; i < stride; ++i) dst[i] = src[i];
                break;
            case 1:  // Sub
                for (long i = 0; i < bpp; ++i) dst[i] = src[i];
                for (long i = bpp; i < stride; ++i)
                    dst[i] = (unsigned char)(src[i] + dst[i - bpp]);
                break;
            case 2:  // Up
                if (prev) {
                    for (long i = 0; i < stride; ++i)
                        dst[i] = (unsigned char)(src[i] + prev[i]);
                } else {
                    for (long i = 0; i < stride; ++i) dst[i] = src[i];
                }
                break;
            case 3:  // Average
                for (long i = 0; i < stride; ++i) {
                    const int left = i >= bpp ? dst[i - bpp] : 0;
                    const int up = prev ? prev[i] : 0;
                    dst[i] = (unsigned char)(src[i] + ((left + up) >> 1));
                }
                break;
            case 4:  // Paeth
                for (long i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? dst[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = p > a ? p - a : a - p;
                    const int pb = p > b ? p - b : b - p;
                    const int pc = p > c ? p - c : c - p;
                    const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    dst[i] = (unsigned char)(src[i] + pred);
                }
                break;
            default:
                return 1 + row;
        }
        prev = dst;
    }
    return 0;
}

}  // extern "C"
