// Host code of utils/webp.py: the WebP codecs, decoded as libwebp decodes
// them for cv2.imdecode (WebPDecodeBGR / WebPDecodeBGRA), every value equal.
//
// * VP8 (lossy) key frames: the boolean decoder, the frame header, segments
//   and quantisers, token probabilities with their updates, coefficients
//   (with the skip flag), the inverse WHT and DCT, intra prediction (16x16,
//   4x4 with its edge samples, chroma) and the simple and normal loop
//   filters, then libwebp's "fancy" upsampling of the chroma and its
//   fixed-point YUV -> BGR (VP8YUVToB/G/R), the default of its simple API
//   (which does no dithering).
// * VP8L (lossless): prefix codes (simple ones and the code-length code),
//   LZ77 backward references with the 120-entry distance map, the colour
//   cache, meta prefix codes (the entropy image), and the predictor (all 14
//   modes), cross-colour, subtract-green and colour-indexing (with pixel
//   bundling) transforms.
// * ALPH: an alpha plane stored raw or as the green channel of a VP8L
//   stream without its header, then unfiltered (none, horizontal,
//   vertical, gradient).
//
// The RIFF container is read by utils/webp.py.  Built with the host's C
// compiler by ops/_build.py (cc -O2 -shared -fPIC) and called through ctypes.

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

// the faults, as utils/webp.py names them
enum {
    WEBP_OK = 0,
    WEBP_NO_MEMORY,
    VP8_TRUNCATED_HEADER,
    VP8_BAD_PROFILE,
    VP8_NOT_SHOWN,
    VP8_NOT_KEY_FRAME,
    VP8_BAD_CODE_WORD,
    VP8_BAD_PARTITION_LENGTH,
    VP8_BAD_SEGMENT_HEADER,
    VP8_BAD_FILTER_HEADER,
    VP8_BAD_PARTITIONS,
    VP8_PREMATURE_END_OF_PARTITION0,
    VP8_PREMATURE_END_OF_FILE,
    VP8_BAD_SIZE,
    VP8L_BAD_HEADER,
    VP8L_BAD_SIZE,
    VP8L_TRUNCATED,
    VP8L_BAD_TRANSFORM,
    VP8L_BAD_CACHE_BITS,
    VP8L_BAD_CODE,
    VP8L_BAD_DISTANCE,
    ALPH_BAD_HEADER,
    ALPH_TRUNCATED,
};

// RFC 6386's quantiser steps (dc_qlookup, ac_qlookup)
static const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20,
    21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
    37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54,
    55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96,
    98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136,
    138, 140, 143, 145, 148, 151, 154, 157,
};
static const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// RFC 6386's default token probabilities and the probabilities of their
// updates, [type][band][context][node], flattened
static const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128,
    128, 128, 128, 128, 189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214,
    209, 255, 255, 128, 128, 128, 1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238,
    254, 221, 234, 255, 154, 128, 128, 128, 78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1,
    185, 249, 255, 243, 255, 128, 128, 128, 128, 128, 184, 150, 247, 255, 236, 224, 128, 128, 128, 128,
    128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128, 1, 101, 251, 255, 241, 255, 128, 128,
    128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128, 37, 116, 196, 243, 228, 255,
    255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128, 207, 160, 250, 255,
    238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128, 1, 152,
    252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172,
    176, 220, 157, 252, 221, 1, 68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241,
    255, 221, 224, 255, 255, 128, 128, 128, 184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81,
    99, 181, 242, 176, 190, 249, 202, 255, 255, 128, 1, 129, 232, 253, 214, 197, 242, 196, 255, 255,
    128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128, 23, 91, 163, 242, 170, 187, 247, 210,
    255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109, 178, 241, 255, 231, 245,
    255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128, 1, 132, 239, 251,
    219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128, 22, 100,
    174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128,
    128, 128, 1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255,
    255, 128, 128, 128, 45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213,
    255, 128, 128, 128, 128, 128, 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177,
    255, 224, 255, 128, 128, 128, 128, 128, 253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175,
    13, 224, 243, 193, 185, 249, 198, 255, 255, 128, 73, 17, 171, 221, 161, 179, 236, 167, 255, 234,
    128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128, 239, 90, 244, 250, 211, 209, 255, 255,
    128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128, 1, 24, 239, 251, 218, 219,
    255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128, 69, 46, 190, 239,
    201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128, 223, 165,
    249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128,
    128, 128, 149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128,
    128, 128, 128, 128, 247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128,
    128, 128, 128, 128, 128, 128, 1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250,
    255, 255, 128, 128, 128, 128, 128, 128, 55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 202, 24, 213, 235, 186, 191, 220, 160,
    240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128, 61, 46, 138, 219, 151, 178,
    240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128, 166, 109, 228, 252,
    211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128, 1, 52,
    220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128,
    128, 128, 149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254,
    223, 255, 255, 128, 1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188,
    196, 255, 233, 128, 128, 128, 20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248,
    255, 216, 213, 128, 128, 128, 128, 128, 168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47,
    116, 215, 255, 211, 212, 255, 255, 128, 128, 128, 1, 121, 236, 253, 212, 214, 255, 255, 128, 128,
    128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128, 42, 80, 160, 240, 162, 185, 255, 205,
    128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 244, 1, 255, 128, 128, 128,
    128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
static const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 254, 255, 255, 255, 255, 255, 255, 255, 255, 239, 253, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254,
    253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255,
    255, 254, 255, 255, 255, 255, 234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238,
    253, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255,
    255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234,
    251, 244, 254, 255, 255, 255, 255, 255, 255, 255, 251, 251, 243, 253, 254, 255, 254, 255, 255, 255,
    255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 236, 253, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255,
    255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 248, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255, 248, 254, 249, 253, 255, 255,
    255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 246, 253, 253, 255,
    255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 254,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255,
    255, 255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

// the key frame's 4x4 mode probabilities, [above][left][node], in libwebp's
// order of the modes (the B_* enum below), flattened
static const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// VP8L's distance codes 1..120: (dy << 4) | (8 - dx) of the 2-D neighbourhood
static const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

// ---------------------------------------------------------------------------
// VP8: the boolean decoder (RFC 6386 section 7).  `range` holds the range
// minus one; `bits` counts the bits held past the current 8; reading past
// the data supplies one zero byte and sets `eof`, as libwebp's reader does.
// It loads 7 bytes at a time while 8 remain, as libwebp's 64-bit reader
// does: on a corrupt stream, whose value may outgrow its range, the bits a
// load shifts out are then the same.
// ---------------------------------------------------------------------------

typedef struct {
    const uint8_t* buf;
    const uint8_t* end;
    const uint8_t* buf_max;
    uint64_t value;
    uint32_t range;
    int bits;
    int eof;
} BoolReader;

static void br_load(BoolReader* br) {
    if (br->buf < br->buf_max) {
        uint64_t bits = 0;
        for (int k = 0; k < 7; ++k) bits = (bits << 8) | br->buf[k];
        br->buf += 7;
        br->value = bits | (br->value << 56);
        br->bits += 56;
    } else if (br->buf < br->end) {
        br->bits += 8;
        br->value = (br->value << 8) | *br->buf++;
    } else if (!br->eof) {
        br->value <<= 8;
        br->bits += 8;
        br->eof = 1;
    } else {
        br->bits = 0;
    }
}

static void br_init(BoolReader* br, const uint8_t* start, size_t size) {
    br->buf = start;
    br->end = start + size;
    br->buf_max = size >= 8 ? start + size - 8 + 1 : start;
    br->value = 0;
    br->range = 255 - 1;
    br->bits = -8;
    br->eof = 0;
    br_load(br);
}

static int br_bit(BoolReader* br, int prob) {
    uint32_t range = br->range;
    if (br->bits < 0) br_load(br);
    const int pos = br->bits;
    const uint32_t split = (range * (uint32_t)prob) >> 8;
    const uint32_t value = (uint32_t)(br->value >> pos);
    int bit;
    if (value > split) {
        range -= split;
        br->value -= (uint64_t)(split + 1) << pos;
        bit = 1;
    } else {
        range = split + 1;
        bit = 0;
    }
    const int shift = 7 ^ (31 ^ __builtin_clz(range));
    range <<= shift;
    br->bits -= shift;
    br->range = range - 1;
    return bit;
}

static int br_value(BoolReader* br, int n) {
    int v = 0;
    while (n-- > 0) v |= br_bit(br, 0x80) << n;
    return v;
}

static int br_signed_value(BoolReader* br, int n) {
    const int v = br_value(br, n);
    return br_value(br, 1) ? -v : v;
}

// ---------------------------------------------------------------------------
// VP8: the frame (RFC 6386; the reconstruction as libwebp's src/dec and
// src/dsp/dec.c compute it, which the format leaves to the decoder only in
// the upsampling and the colour conversion at the end)
// ---------------------------------------------------------------------------

enum {
    B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
    B_VL_PRED, B_HD_PRED, B_HU_PRED,
    DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
    B_DC_PRED_NOTOP = 4, B_DC_PRED_NOLEFT = 5, B_DC_PRED_NOTOPLEFT = 6
};

static const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
static const uint8_t kCat3[] = {173, 148, 140, 0};
static const uint8_t kCat4[] = {176, 155, 140, 135, 0};
static const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
static const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
static const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

typedef struct {
    uint8_t is_i4x4, uvmode, segment, skip;
    uint8_t imodes[16];
    // each 4x4 block's inverse transform, as libwebp picks it: 0 none, 1 DC
    // only, 2 the first three coefficients, 3 all (luma, then U and V)
    uint8_t codes[24];
    int16_t coeffs[384];
} MBData;

typedef struct {
    uint8_t limit, ilevel, inner, hev_thresh;
} FilterInfo;

typedef struct {
    int width, height, mb_w, mb_h;
    BoolReader br;
    BoolReader parts[8];
    int num_parts;
    int use_segment, update_map, absolute_delta;
    int quantizer[4], filter_strength[4];
    uint8_t segment_probs[3];
    int simple, level, sharpness, use_lf_delta;
    int ref_lf_delta[4], mode_lf_delta[4];
    int filter_type;
    int dq[4][3][2];  // per segment: y1, y2, uv; dc and ac
    uint8_t proba[4][8][3][11];
    int use_skip_proba, skip_p;
    FilterInfo fstrengths[4][2];
} VP8Dec;

static int clip_q(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

static void parse_quant(VP8Dec* d) {
    BoolReader* br = &d->br;
    const int base_q0 = br_value(br, 7);
    int dq[5];
    for (int k = 0; k < 5; ++k) dq[k] = br_value(br, 1) ? br_signed_value(br, 4) : 0;
    for (int s = 0; s < 4; ++s) {
        int q;
        if (d->use_segment) {
            q = d->quantizer[s] + (d->absolute_delta ? 0 : base_q0);
        } else if (s > 0) {
            memcpy(d->dq[s], d->dq[0], sizeof(d->dq[0]));
            continue;
        } else {
            q = base_q0;
        }
        d->dq[s][0][0] = kDcTable[clip_q(q + dq[0], 127)];
        d->dq[s][0][1] = kAcTable[clip_q(q, 127)];
        d->dq[s][1][0] = kDcTable[clip_q(q + dq[1], 127)] * 2;
        // x * 155 / 100 for every x of the table, as (x * 101581) >> 16
        d->dq[s][1][1] = (kAcTable[clip_q(q + dq[2], 127)] * 101581) >> 16;
        if (d->dq[s][1][1] < 8) d->dq[s][1][1] = 8;
        d->dq[s][2][0] = kDcTable[clip_q(q + dq[3], 117)];
        d->dq[s][2][1] = kAcTable[clip_q(q + dq[4], 127)];
    }
}

static void filter_strengths(VP8Dec* d) {
    for (int s = 0; s < 4; ++s) {
        int base = d->level;
        if (d->use_segment) {
            base = d->filter_strength[s];
            if (!d->absolute_delta) base += d->level;
        }
        for (int i4 = 0; i4 <= 1; ++i4) {
            FilterInfo* info = &d->fstrengths[s][i4];
            int level = base;
            if (d->use_lf_delta) {
                level += d->ref_lf_delta[0];
                if (i4) level += d->mode_lf_delta[0];
            }
            level = level < 0 ? 0 : level > 63 ? 63 : level;
            if (level > 0) {
                int ilevel = level;
                if (d->sharpness > 0) {
                    ilevel >>= d->sharpness > 4 ? 2 : 1;
                    if (ilevel > 9 - d->sharpness) ilevel = 9 - d->sharpness;
                }
                if (ilevel < 1) ilevel = 1;
                info->ilevel = (uint8_t)ilevel;
                info->limit = (uint8_t)(2 * level + ilevel);
                info->hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
            } else {
                info->limit = 0;
            }
            info->inner = (uint8_t)i4;
        }
    }
}

// The frame header and the first partition's global part; the token
// partitions' readers.  Returns WEBP_OK or the fault.
static int parse_headers(VP8Dec* d, const uint8_t* data, size_t size) {
    if (size < 4) return VP8_TRUNCATED_HEADER;
    const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    const int key_frame = !(bits & 1);
    const uint32_t part0 = bits >> 5;
    if (((bits >> 1) & 7) > 3) return VP8_BAD_PROFILE;
    if (!((bits >> 4) & 1)) return VP8_NOT_SHOWN;
    data += 3;
    size -= 3;
    if (!key_frame) return VP8_NOT_KEY_FRAME;
    if (size < 7) return VP8_TRUNCATED_HEADER;
    if (data[0] != 0x9d || data[1] != 0x01 || data[2] != 0x2a) return VP8_BAD_CODE_WORD;
    d->width = ((data[4] << 8) | data[3]) & 0x3fff;
    d->height = ((data[6] << 8) | data[5]) & 0x3fff;
    d->mb_w = (d->width + 15) >> 4;
    d->mb_h = (d->height + 15) >> 4;
    data += 7;
    size -= 7;
    if (part0 > size) return VP8_BAD_PARTITION_LENGTH;
    BoolReader* br = &d->br;
    br_init(br, data, part0);
    data += part0;
    size -= part0;

    br_value(br, 1);  // colour space
    br_value(br, 1);  // clamping type (the decoder always clamps)
    // segment header
    d->absolute_delta = 1;
    memset(d->segment_probs, 255, 3);
    d->use_segment = br_value(br, 1);
    if (d->use_segment) {
        d->update_map = br_value(br, 1);
        if (br_value(br, 1)) {
            d->absolute_delta = br_value(br, 1);
            for (int s = 0; s < 4; ++s) d->quantizer[s] = br_value(br, 1) ? br_signed_value(br, 7) : 0;
            for (int s = 0; s < 4; ++s)
                d->filter_strength[s] = br_value(br, 1) ? br_signed_value(br, 6) : 0;
        }
        if (d->update_map)
            for (int s = 0; s < 3; ++s) d->segment_probs[s] = br_value(br, 1) ? br_value(br, 8) : 255;
    }
    if (br->eof) return VP8_BAD_SEGMENT_HEADER;
    // filter header
    d->simple = br_value(br, 1);
    d->level = br_value(br, 6);
    d->sharpness = br_value(br, 3);
    d->use_lf_delta = br_value(br, 1);
    if (d->use_lf_delta && br_value(br, 1)) {
        for (int i = 0; i < 4; ++i)
            if (br_value(br, 1)) d->ref_lf_delta[i] = br_signed_value(br, 6);
        for (int i = 0; i < 4; ++i)
            if (br_value(br, 1)) d->mode_lf_delta[i] = br_signed_value(br, 6);
    }
    d->filter_type = d->level == 0 ? 0 : d->simple ? 1 : 2;
    if (br->eof) return VP8_BAD_FILTER_HEADER;
    // partitions: the sizes of all but the last, then the data
    d->num_parts = 1 << br_value(br, 2);
    const size_t last = (size_t)d->num_parts - 1;
    if (size < 3 * last) return VP8_BAD_PARTITIONS;
    const uint8_t* sz = data;
    const uint8_t* start = data + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p) {
        size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
        if (psize > left) psize = left;
        br_init(&d->parts[p], start, psize);
        start += psize;
        left -= psize;
        sz += 3;
    }
    br_init(&d->parts[last], start, left);
    if (start >= data + size) return VP8_BAD_PARTITIONS;
    parse_quant(d);
    br_value(br, 1);  // refresh the probabilities (one frame: nothing to keep)
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
            for (int c = 0; c < 3; ++c)
                for (int p = 0; p < 11; ++p) {
                    const int i = ((t * 8 + b) * 3 + c) * 11 + p;
                    d->proba[t][b][c][p] = br_bit(br, kCoeffsUpdateProba[i])
                                               ? (uint8_t)br_value(br, 8) : kCoeffsProba0[i];
                }
    d->use_skip_proba = br_value(br, 1);
    if (d->use_skip_proba) d->skip_p = br_value(br, 8);
    filter_strengths(d);
    return WEBP_OK;
}

// One macroblock's modes from the first partition (libwebp's ParseIntraMode).
static void parse_intra_mode(VP8Dec* d, uint8_t* top, uint8_t* left, MBData* mb) {
    BoolReader* br = &d->br;
    if (d->update_map) {
        mb->segment = !br_bit(br, d->segment_probs[0]) ? br_bit(br, d->segment_probs[1])
                                                        : br_bit(br, d->segment_probs[2]) + 2;
    } else {
        mb->segment = 0;
    }
    mb->skip = d->use_skip_proba ? br_bit(br, d->skip_p) : 0;
    mb->is_i4x4 = !br_bit(br, 145);
    if (!mb->is_i4x4) {
        const int ymode = br_bit(br, 156) ? (br_bit(br, 128) ? TM_PRED : H_PRED)
                                          : (br_bit(br, 163) ? V_PRED : DC_PRED);
        mb->imodes[0] = (uint8_t)ymode;
        memset(top, ymode, 4);
        memset(left, ymode, 4);
    } else {
        uint8_t* modes = mb->imodes;
        for (int y = 0; y < 4; ++y) {
            int ymode = left[y];
            for (int x = 0; x < 4; ++x) {
                const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
                ymode = !br_bit(br, prob[0]) ? B_DC_PRED
                      : !br_bit(br, prob[1]) ? B_TM_PRED
                      : !br_bit(br, prob[2]) ? B_VE_PRED
                      : !br_bit(br, prob[3])
                          ? (!br_bit(br, prob[4]) ? B_HE_PRED
                             : !br_bit(br, prob[5]) ? B_RD_PRED : B_VR_PRED)
                          : (!br_bit(br, prob[6]) ? B_LD_PRED
                             : !br_bit(br, prob[7]) ? B_VL_PRED
                             : !br_bit(br, prob[8]) ? B_HD_PRED : B_HU_PRED);
                top[x] = (uint8_t)ymode;
            }
            memcpy(modes, top, 4);
            modes += 4;
            left[y] = (uint8_t)ymode;
        }
    }
    mb->uvmode = !br_bit(br, 142) ? DC_PRED
               : !br_bit(br, 114) ? V_PRED
               : br_bit(br, 183) ? TM_PRED : H_PRED;
}

static int large_value(BoolReader* br, const uint8_t* p) {
    int v;
    if (!br_bit(br, p[3])) {
        v = !br_bit(br, p[4]) ? 2 : 3 + br_bit(br, p[5]);
    } else if (!br_bit(br, p[6])) {
        if (!br_bit(br, p[7])) {
            v = 5 + br_bit(br, 159);
        } else {
            v = 7 + 2 * br_bit(br, 165);
            v += br_bit(br, 145);
        }
    } else {
        const int bit1 = br_bit(br, p[8]);
        const int bit0 = br_bit(br, p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br_bit(br, *tab);
        v += 3 + (8 << cat);
    }
    return v;
}

// The coefficients of one 4x4 block from position n on, dequantised; the
// position of the last non-zero one plus one (libwebp's GetCoeffs).
static int get_coeffs(BoolReader* br, uint8_t (*bands)[3][11], int ctx, const int dq[2], int n,
                      int16_t* out) {
    const uint8_t* p = bands[kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!br_bit(br, p[0])) return n;
        while (!br_bit(br, p[1])) {
            p = bands[kBands[++n]][0];
            if (n == 16) return 16;
        }
        int v;
        if (!br_bit(br, p[2])) {
            v = 1;
            p = bands[kBands[n + 1]][1];
        } else {
            v = large_value(br, p);
            p = bands[kBands[n + 1]][2];
        }
        out[kZigzag[n]] = (int16_t)((br_bit(br, 0x80) ? -v : v) * dq[n > 0]);
    }
    return 16;
}

static void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4];
        const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        const int a3 = dc - tmp[3 + i * 4];
        out[0] = (int16_t)((a0 + a1) >> 3);
        out[16] = (int16_t)((a3 + a2) >> 3);
        out[32] = (int16_t)((a0 - a1) >> 3);
        out[48] = (int16_t)((a3 - a2) >> 3);
        out += 64;
    }
}

static uint8_t nz_code(int nz, int dc_nz) { return nz > 3 ? 3 : nz > 1 ? 2 : (uint8_t)dc_nz; }

// The residuals of one macroblock (libwebp's ParseResiduals): returns
// whether every coefficient is zero.  `tnz`/`lnz`: the top and left
// non-zero flags (4 luma bits, then 2 + 2 chroma), `tdc`/`ldc` the Y2's.
static int parse_residuals(VP8Dec* d, BoolReader* br, MBData* mb, uint8_t* top_nz,
                           uint8_t* top_dc, uint8_t* left_nz, uint8_t* left_dc) {
    const int(*q)[2] = d->dq[mb->segment];
    int16_t* dst = mb->coeffs;
    uint8_t(*ac_proba)[3][11];
    int first;
    int nonzero = 0;
    memset(dst, 0, 384 * sizeof(*dst));
    if (!mb->is_i4x4) {
        int16_t dc[16] = {0};
        const int ctx = *top_dc + *left_dc;
        const int nz = get_coeffs(br, d->proba[1], ctx, q[1], 0, dc);
        *top_dc = *left_dc = (nz > 0);
        if (nz > 1) {
            transform_wht(dc, dst);
        } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
        }
        first = 1;
        ac_proba = d->proba[0];
    } else {
        first = 0;
        ac_proba = d->proba[3];
    }
    uint8_t tnz = *top_nz & 0x0f, lnz = *left_nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 4; ++x) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(br, ac_proba, ctx, q[0], first, dst);
            l = (nz > first);
            tnz = (uint8_t)((tnz >> 1) | (l << 7));
            mb->codes[y * 4 + x] = nz_code(nz, dst[0] != 0);
            nonzero |= mb->codes[y * 4 + x];
            dst += 16;
        }
        tnz >>= 4;
        lnz = (uint8_t)((lnz >> 1) | (l << 7));
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
        uint32_t t = *top_nz >> (4 + ch), lf = *left_nz >> (4 + ch);
        for (int y = 0; y < 2; ++y) {
            int l = lf & 1;
            for (int x = 0; x < 2; ++x) {
                const int ctx = l + (t & 1);
                const int nz = get_coeffs(br, d->proba[2], ctx, q[2], 0, dst);
                l = (nz > 0);
                t = (t >> 1) | (l << 3);
                mb->codes[16 + ch * 2 + y * 2 + x] = nz_code(nz, dst[0] != 0);
                nonzero |= mb->codes[16 + ch * 2 + y * 2 + x];
                dst += 16;
            }
            t >>= 2;
            lf = (lf >> 1) | (l << 5);
        }
        out_t |= (t << 4) << ch;
        out_l |= (lf & 0xf0) << ch;
    }
    *top_nz = (uint8_t)out_t;
    *left_nz = (uint8_t)out_l;
    return !nonzero;
}

// --- reconstruction: libwebp's work area of stride BPS ---------------------

#define BPS 32
#define YUV_SIZE (BPS * 17 + BPS * 9)
#define Y_OFF (BPS * 1 + 8)
#define U_OFF (Y_OFF + BPS * 16 + BPS)
#define V_OFF (U_OFF + 16)

static uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)
#define STORE(x, y, v) dst[(x) + (y) * BPS] = clip8(dst[(x) + (y) * BPS] + ((v) >> 3))

// The inverse DCT of one 4x4 block, added to the prediction in place.
static void transform_one(const int16_t* in, uint8_t* dst) {
    int C[16], *tmp = C;
    for (int i = 0; i < 4; ++i) {
        const int a = in[0] + in[8];
        const int b = in[0] - in[8];
        const int c = MUL2(in[4]) - MUL1(in[12]);
        const int d = MUL1(in[4]) + MUL2(in[12]);
        tmp[0] = a + d;
        tmp[1] = b + c;
        tmp[2] = b - c;
        tmp[3] = a - d;
        tmp += 4;
        in++;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0] + 4;
        const int a = dc + tmp[8];
        const int b = dc - tmp[8];
        const int c = MUL2(tmp[4]) - MUL1(tmp[12]);
        const int d = MUL1(tmp[4]) + MUL2(tmp[12]);
        STORE(0, 0, a + d);
        STORE(1, 0, b + c);
        STORE(2, 0, b - c);
        STORE(3, 0, a - d);
        tmp++;
        dst += BPS;
    }
}

// The same with libwebp's SSE2 code, which the x86 builds run for a block
// of every coefficient: the same sums in 16-bit lanes that wrap, a
// multiply's high half, and the sum with the prediction saturated.  On a
// valid stream it equals transform_one; on coefficients past what an
// encoder writes, it gives what cv2 gives.
static int16_t w16(int v) { return (int16_t)(uint16_t)v; }
static int16_t mulhi(int16_t a, int k) { return (int16_t)(((int32_t)a * k) >> 16); }

static void transform_sse2(const int16_t* in, uint8_t* dst) {
    int16_t T[16], R[16];
    for (int pass = 0; pass < 2; ++pass) {
        const int16_t* src = pass ? T : in;
        int16_t* out = pass ? R : T;
        for (int i = 0; i < 4; ++i) {  // column i of the pass's input
            const int16_t i0 = src[0 + i], i1 = src[4 + i], i2 = src[8 + i], i3 = src[12 + i];
            const int16_t base = pass ? w16(i0 + 4) : i0;
            const int16_t a = w16(base + i2), b = w16(base - i2);
            const int16_t c = w16(w16(i1 - i3) + w16(mulhi(i1, -30068) - mulhi(i3, 20091)));
            const int16_t d = w16(w16(i1 + i3) + w16(mulhi(i1, 20091) + mulhi(i3, -30068)));
            const int16_t o[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
            for (int k = 0; k < 4; ++k)  // transposed: the outputs of column i form row i
                out[i * 4 + k] = pass ? (int16_t)(o[k] >> 3) : o[k];
        }
    }
    for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) dst[x + y * BPS] = clip8(w16(dst[x + y * BPS] + R[y * 4 + x]));
}

// one block's transform by its code
static void transform_block(int code, const int16_t* in, uint8_t* dst) {
    if (code == 3) transform_sse2(in, dst);
    else if (code) transform_one(in, dst);
}

#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

static void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    const int tl = top[-1];
    for (int y = 0; y < size; ++y) {
        for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - tl);
        dst += BPS;
    }
}

static void fill(uint8_t* dst, int v, int size) {
    for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

// 16x16 luma and 8x8 chroma: DC (all, no top, no left, none), TM, VE, HE
static void predict_block(uint8_t* dst, int mode, int size) {
    const int shift = size == 16 ? 4 : 3;
    int dc = 0;
    switch (mode) {
    case DC_PRED:
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
        fill(dst, (dc + size) >> (shift + 1), size);
        break;
    case B_DC_PRED_NOTOP:
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
        fill(dst, (dc + size / 2) >> shift, size);
        break;
    case B_DC_PRED_NOLEFT:
        for (int j = 0; j < size; ++j) dc += dst[j - BPS];
        fill(dst, (dc + size / 2) >> shift, size);
        break;
    case B_DC_PRED_NOTOPLEFT:
        fill(dst, 0x80, size);
        break;
    case TM_PRED:
        true_motion(dst, size);
        break;
    case V_PRED:
        for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
        break;
    default:  // H_PRED
        for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[-1 + j * BPS], size);
        break;
    }
}

// 4x4 luma: the ten modes
static void predict4(uint8_t* dst, int mode) {
    const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS];
    const int L = dst[-1 + 3 * BPS], X = dst[-1 - BPS];
    const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
    const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
    switch (mode) {
    case B_DC_PRED: {
        int dc = 4;
        for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
        fill(dst, dc >> 3, 4);
        break;
    }
    case B_TM_PRED:
        true_motion(dst, 4);
        break;
    case B_VE_PRED: {
        const uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D), AVG3(C, D, E)};
        for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
        break;
    }
    case B_HE_PRED:
        memset(dst + 0 * BPS, AVG3(X, I, J), 4);
        memset(dst + 1 * BPS, AVG3(I, J, K), 4);
        memset(dst + 2 * BPS, AVG3(J, K, L), 4);
        memset(dst + 3 * BPS, AVG3(K, L, L), 4);
        break;
    case B_RD_PRED:
        DST(0, 3) = AVG3(J, K, L);
        DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
        DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
        DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
        DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
        DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
        DST(3, 0) = AVG3(D, C, B);
        break;
    case B_LD_PRED:
        DST(0, 0) = AVG3(A, B, C);
        DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
        DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
        DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
        DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
        DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
        DST(3, 3) = AVG3(G, H, H);
        break;
    case B_VR_PRED:
        DST(0, 0) = DST(1, 2) = AVG2(X, A);
        DST(1, 0) = DST(2, 2) = AVG2(A, B);
        DST(2, 0) = DST(3, 2) = AVG2(B, C);
        DST(3, 0) = AVG2(C, D);
        DST(0, 3) = AVG3(K, J, I);
        DST(0, 2) = AVG3(J, I, X);
        DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
        DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
        DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
        DST(3, 1) = AVG3(B, C, D);
        break;
    case B_VL_PRED:
        DST(0, 0) = AVG2(A, B);
        DST(1, 0) = DST(0, 2) = AVG2(B, C);
        DST(2, 0) = DST(1, 2) = AVG2(C, D);
        DST(3, 0) = DST(2, 2) = AVG2(D, E);
        DST(0, 1) = AVG3(A, B, C);
        DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
        DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
        DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
        DST(3, 2) = AVG3(E, F, G);
        DST(3, 3) = AVG3(F, G, H);
        break;
    case B_HD_PRED:
        DST(0, 0) = DST(2, 1) = AVG2(I, X);
        DST(0, 1) = DST(2, 2) = AVG2(J, I);
        DST(0, 2) = DST(2, 3) = AVG2(K, J);
        DST(0, 3) = AVG2(L, K);
        DST(3, 0) = AVG3(A, B, C);
        DST(2, 0) = AVG3(X, A, B);
        DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
        DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
        DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
        DST(1, 3) = AVG3(L, K, J);
        break;
    default:  // B_HU_PRED
        DST(0, 0) = AVG2(I, J);
        DST(2, 0) = DST(0, 1) = AVG2(J, K);
        DST(2, 1) = DST(0, 2) = AVG2(K, L);
        DST(1, 0) = AVG3(I, J, K);
        DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
        DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
        DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
        break;
    }
}

static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
        if (mb_x == 0) return mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
        return mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED;
    }
    return mode;
}

// One row of macroblocks predicted and reconstructed into the frame's
// planes (libwebp's ReconstructRow: the left and top samples unfiltered,
// 129 left of the frame, 127 above it).
static void reconstruct_row(VP8Dec* d, int mb_y, const MBData* mbs, uint8_t* yuv_b,
                            uint8_t* top_y, uint8_t* top_u, uint8_t* top_v, uint8_t* Y,
                            uint8_t* U, uint8_t* V) {
    uint8_t* const y_dst = yuv_b + Y_OFF;
    uint8_t* const u_dst = yuv_b + U_OFF;
    uint8_t* const v_dst = yuv_b + V_OFF;
    const int ys = d->mb_w * 16, uvs = d->mb_w * 8;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
        memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        memset(u_dst - BPS - 1, 127, 8 + 1);
        memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < d->mb_w; ++mb_x) {
        const MBData* mb = mbs + mb_x;
        if (mb_x > 0) {
            for (int j = -1; j < 16; ++j) memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
            for (int j = -1; j < 8; ++j) {
                memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
                memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
            }
        }
        uint8_t* ty = top_y + mb_x * 16;
        uint8_t* tu = top_u + mb_x * 8;
        uint8_t* tv = top_v + mb_x * 8;
        if (mb_y > 0) {
            memcpy(y_dst - BPS, ty, 16);
            memcpy(u_dst - BPS, tu, 8);
            memcpy(v_dst - BPS, tv, 8);
        }
        if (mb->is_i4x4) {
            uint8_t* top_right = y_dst - BPS + 16;
            if (mb_y > 0) {
                if (mb_x >= d->mb_w - 1) memset(top_right, ty[15], 4);
                else memcpy(top_right, ty + 16, 4);
            }
            // the top-right samples repeated beside rows 3, 7 and 11
            for (int k = 1; k < 4; ++k) memcpy(top_right + 4 * k * BPS, top_right, 4);
            for (int n = 0; n < 16; ++n) {
                uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
                predict4(dst, mb->imodes[n]);
                transform_block(mb->codes[n], mb->coeffs + n * 16, dst);
            }
        } else {
            predict_block(y_dst, check_mode(mb_x, mb_y, mb->imodes[0]), 16);
            for (int n = 0; n < 16; ++n)
                transform_block(mb->codes[n], mb->coeffs + n * 16,
                                y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
        const int uvmode = check_mode(mb_x, mb_y, mb->uvmode);
        predict_block(u_dst, uvmode, 8);
        predict_block(v_dst, uvmode, 8);
        for (int ch = 0; ch < 2; ++ch) {
            // a plane with any AC coefficient takes the full transform on all
            // four blocks, else the DC one (libwebp's DoUVTransform)
            const uint8_t* codes = mb->codes + 16 + 4 * ch;
            int any = 0, ac = 0;
            for (int n = 0; n < 4; ++n) {
                any |= codes[n];
                ac |= codes[n] > 1;
            }
            for (int n = 0; n < 4 && any; ++n)
                transform_block(ac ? 3 : 1, mb->coeffs + (16 + 4 * ch + n) * 16,
                                (ch ? v_dst : u_dst) + (n & 1) * 4 + (n >> 1) * 4 * BPS);
        }
        if (mb_y < d->mb_h - 1) {
            memcpy(ty, y_dst + 15 * BPS, 16);
            memcpy(tu, u_dst + 7 * BPS, 8);
            memcpy(tv, v_dst + 7 * BPS, 8);
        }
        for (int j = 0; j < 16; ++j)
            memcpy(Y + (size_t)(mb_y * 16 + j) * ys + mb_x * 16, y_dst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
            memcpy(U + (size_t)(mb_y * 8 + j) * uvs + mb_x * 8, u_dst + j * BPS, 8);
            memcpy(V + (size_t)(mb_y * 8 + j) * uvs + mb_x * 8, v_dst + j * BPS, 8);
        }
    }
}

// --- the loop filter (RFC 6386 section 15, as libwebp's dsp/dec.c) ---------

static int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
static int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]

static void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

static void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

static void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

static int hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}

static int needs_filter(const uint8_t* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

static int needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return 0;
    return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it && abs(q3 - q2) <= it
           && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

// the simple filter across one edge of `size` samples: `hstride` across
// the edge, `vstride` along it
static void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
    const int thresh2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i, p += vstride)
        if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

// the normal filter: `mbedge` the macroblock edge (6 taps), else inner (4)
static void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                        int hev_thresh, int mbedge) {
    const int thresh2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += vstride) {
        if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
        if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
        else if (mbedge) do_filter6(p, hstride);
        else do_filter4(p, hstride);
    }
}

static void filter_mb(const VP8Dec* d, const FilterInfo* f, int mb_x, int mb_y, uint8_t* Y,
                      uint8_t* U, uint8_t* V) {
    const int limit = f->limit, ilevel = f->ilevel, hev_t = f->hev_thresh;
    const int ys = d->mb_w * 16, uvs = d->mb_w * 8;
    uint8_t* y = Y + (size_t)mb_y * 16 * ys + mb_x * 16;
    if (limit == 0) return;
    if (d->filter_type == 1) {
        if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
        if (f->inner)
            for (int k = 1; k < 4; ++k) simple_edge(y + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
        if (f->inner)
            for (int k = 1; k < 4; ++k) simple_edge(y + 4 * k * ys, ys, 1, limit);
        return;
    }
    uint8_t* u = U + (size_t)mb_y * 8 * uvs + mb_x * 8;
    uint8_t* v = V + (size_t)mb_y * 8 * uvs + mb_x * 8;
    if (mb_x > 0) {
        normal_edge(y, 1, ys, 16, limit + 4, ilevel, hev_t, 1);
        normal_edge(u, 1, uvs, 8, limit + 4, ilevel, hev_t, 1);
        normal_edge(v, 1, uvs, 8, limit + 4, ilevel, hev_t, 1);
    }
    if (f->inner) {
        for (int k = 1; k < 4; ++k) normal_edge(y + 4 * k, 1, ys, 16, limit, ilevel, hev_t, 0);
        normal_edge(u + 4, 1, uvs, 8, limit, ilevel, hev_t, 0);
        normal_edge(v + 4, 1, uvs, 8, limit, ilevel, hev_t, 0);
    }
    if (mb_y > 0) {
        normal_edge(y, ys, 1, 16, limit + 4, ilevel, hev_t, 1);
        normal_edge(u, uvs, 1, 8, limit + 4, ilevel, hev_t, 1);
        normal_edge(v, uvs, 1, 8, limit + 4, ilevel, hev_t, 1);
    }
    if (f->inner) {
        for (int k = 1; k < 4; ++k)
            normal_edge(y + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t, 0);
        normal_edge(u + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, 0);
        normal_edge(v + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, 0);
    }
}

// --- output: libwebp's fancy upsampling and fixed-point YUV -> BGR ---------

static int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
static int yuv_clip8(int v) {
    return (v & ~((256 << 6) - 1)) == 0 ? (v >> 6) : v < 0 ? 0 : 255;
}

static void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
    const int yy = mult_hi(y, 19077);
    bgr[0] = (uint8_t)yuv_clip8(yy + mult_hi(u, 33050) - 17685);
    bgr[1] = (uint8_t)yuv_clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    bgr[2] = (uint8_t)yuv_clip8(yy + mult_hi(v, 26149) - 14234);
}

// One output row from its luma row and two chroma rows: `nu`/`nv` the
// nearer (weight 3 of 4 vertically), `fu`/`fv` the farther, each chroma
// sample spread over the pixels about it with weights 9-3-3-1.
static void upsample_row(const uint8_t* y, const uint8_t* nu, const uint8_t* nv,
                         const uint8_t* fu, const uint8_t* fv, uint8_t* out, int len, int ch) {
    const int last_pair = (len - 1) >> 1;
    yuv_to_bgr(y[0], (3 * nu[0] + fu[0] + 2) >> 2, (3 * nv[0] + fv[0] + 2) >> 2, out);
    if (ch == 4) out[3] = 255;
    for (int x = 1; x <= last_pair; ++x) {
        const int au = nu[x - 1] + nu[x] + fu[x - 1] + fu[x] + 8;
        const int av = nv[x - 1] + nv[x] + fv[x - 1] + fv[x] + 8;
        const int du1 = (au + 2 * (nu[x] + fu[x - 1])) >> 3;
        const int du2 = (au + 2 * (nu[x - 1] + fu[x])) >> 3;
        const int dv1 = (av + 2 * (nv[x] + fv[x - 1])) >> 3;
        const int dv2 = (av + 2 * (nv[x - 1] + fv[x])) >> 3;
        uint8_t* o = out + (2 * x - 1) * ch;
        yuv_to_bgr(y[2 * x - 1], (du1 + nu[x - 1]) >> 1, (dv1 + nv[x - 1]) >> 1, o);
        yuv_to_bgr(y[2 * x], (du2 + nu[x]) >> 1, (dv2 + nv[x]) >> 1, o + ch);
        if (ch == 4) o[3] = o[7] = 255;
    }
    if (!(len & 1)) {
        uint8_t* o = out + (len - 1) * ch;
        yuv_to_bgr(y[len - 1], (3 * nu[last_pair] + fu[last_pair] + 2) >> 2,
                   (3 * nv[last_pair] + fv[last_pair] + 2) >> 2, o);
        if (ch == 4) o[3] = 255;
    }
}

// A VP8 key frame of width x height decoded and loop-filtered: its Y plane
// (mb_w * 16 a row, mb_h * 16 rows) then U and V (mb_w * 8 a row), into
// *planes (malloc'd; the caller frees it).  `data`: the chunk's payload and
// whatever follows it in the file, as libwebp hands it to its decoder.
static int decode_frame(const uint8_t* data, size_t size, int width, int height, VP8Dec* d,
                        uint8_t** planes_out) {
    int err = parse_headers(d, data, size);
    if (err == WEBP_OK && (d->width != width || d->height != height)) err = VP8_BAD_SIZE;
    if (err != WEBP_OK) return err;
    const int mb_w = d->mb_w, mb_h = d->mb_h;
    const size_t ysize = (size_t)mb_w * 16 * mb_h * 16, uvsize = (size_t)mb_w * 8 * mb_h * 8;
    uint8_t* planes = malloc(ysize + 2 * uvsize);
    MBData* mbs = malloc(sizeof(MBData) * mb_w);
    FilterInfo* finfo = malloc(sizeof(FilterInfo) * (size_t)mb_w * mb_h);
    uint8_t* ctx = calloc((size_t)mb_w * (4 + 2 + 32), 1);  // intra_t, nz / nz_dc, top samples
    uint8_t* yuv_b = calloc(YUV_SIZE, 1);
    if (!planes || !mbs || !finfo || !ctx || !yuv_b) {
        err = WEBP_NO_MEMORY;
        goto done;
    }
    uint8_t *Y = planes, *U = planes + ysize, *V = U + uvsize;
    uint8_t* intra_t = ctx;
    uint8_t* top_nz = ctx + 4 * mb_w;
    uint8_t* top_dc = top_nz + mb_w;
    uint8_t* top_y = top_dc + mb_w;
    uint8_t* top_u = top_y + 16 * mb_w;
    uint8_t* top_v = top_u + 8 * mb_w;
    memset(intra_t, B_DC_PRED, 4 * (size_t)mb_w);
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
        BoolReader* tokens = &d->parts[mb_y & (d->num_parts - 1)];
        uint8_t intra_l[4], left_nz = 0, left_dc = 0;
        memset(intra_l, B_DC_PRED, 4);
        for (int mb_x = 0; mb_x < mb_w; ++mb_x)
            parse_intra_mode(d, intra_t + 4 * mb_x, intra_l, mbs + mb_x);
        if (d->br.eof) {
            err = VP8_PREMATURE_END_OF_PARTITION0;
            goto done;
        }
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
            MBData* mb = mbs + mb_x;
            int skip = mb->skip;
            if (!skip) {
                skip = parse_residuals(d, tokens, mb, top_nz + mb_x, top_dc + mb_x, &left_nz,
                                       &left_dc);
            } else {
                left_nz = top_nz[mb_x] = 0;
                if (!mb->is_i4x4) left_dc = top_dc[mb_x] = 0;
                memset(mb->codes, 0, sizeof(mb->codes));
            }
            if (d->filter_type > 0) {
                FilterInfo* f = finfo + (size_t)mb_y * mb_w + mb_x;
                *f = d->fstrengths[mb->segment][mb->is_i4x4];
                f->inner |= !skip;
            }
            if (tokens->eof) {
                err = VP8_PREMATURE_END_OF_FILE;
                goto done;
            }
        }
        reconstruct_row(d, mb_y, mbs, yuv_b, top_y, top_u, top_v, Y, U, V);
    }
    // the intra prediction reads unfiltered samples, so the filter may run
    // over the whole frame afterwards, macroblock by macroblock
    if (d->filter_type > 0)
        for (int mb_y = 0; mb_y < mb_h; ++mb_y)
            for (int mb_x = 0; mb_x < mb_w; ++mb_x)
                filter_mb(d, finfo + (size_t)mb_y * mb_w + mb_x, mb_x, mb_y, Y, U, V);
done:
    if (err == WEBP_OK) *planes_out = planes;
    else free(planes);
    free(mbs);
    free(finfo);
    free(ctx);
    free(yuv_b);
    return err;
}

// A VP8 key frame (see decode_frame) as BGR (channels 3) or BGRA with
// alpha 255 (channels 4), width x height, `width * channels` bytes a row.
// Returns WEBP_OK or the fault.
int vp8_decode(const uint8_t* data, int64_t size, int width, int height, uint8_t* out,
               int channels) {
    VP8Dec* d = calloc(1, sizeof(VP8Dec));
    uint8_t* planes = NULL;
    if (d == NULL) return WEBP_NO_MEMORY;
    const int err = decode_frame(data, (size_t)size, width, height, d, &planes);
    if (err == WEBP_OK) {
        const int ys = d->mb_w * 16, uvs = d->mb_w * 8, uv_rows = (height + 1) / 2;
        const uint8_t* Y = planes;
        const uint8_t* U = Y + (size_t)ys * d->mb_h * 16;
        const uint8_t* V = U + (size_t)uvs * d->mb_h * 8;
        for (int y = 0; y < height; ++y) {
            // the chroma row nearer this row, and the farther one (the
            // first and a last even row repeat theirs)
            int near, far;
            if (y == 0) {
                near = far = 0;
            } else if (y & 1) {
                near = (y - 1) / 2;
                far = (y + 1) / 2 < uv_rows ? (y + 1) / 2 : near;
            } else {
                near = y / 2;
                far = y / 2 - 1;
            }
            upsample_row(Y + (size_t)y * ys, U + (size_t)near * uvs, V + (size_t)near * uvs,
                         U + (size_t)far * uvs, V + (size_t)far * uvs,
                         out + (size_t)y * width * channels, width, channels);
        }
    }
    free(planes);
    free(d);
    return err;
}

// ---------------------------------------------------------------------------
// VP8L: the lossless format (RFC 9649), as libwebp's src/dec/vp8l_dec.c
// decodes it
// ---------------------------------------------------------------------------

#define NUM_LITERAL_CODES 256
#define NUM_LENGTH_CODES 24
#define NUM_DISTANCE_CODES 40
#define MAX_CACHE_BITS 11
#define MAX_CODE_LENGTH 15
#define TABLE_BITS 10

static const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                                 7, 8, 9, 10, 11, 12, 13, 14, 15};

typedef struct {
    const uint8_t* data;
    size_t len;
    uint64_t pos;  // bits read
} LBitReader;

// the next n (<= 32) bits, the first read the lowest; past the data, zeros
static uint32_t lbr_peek(const LBitReader* br, int n) {
    const uint64_t byte = br->pos >> 3;
    uint64_t w = 0;
    for (int k = 0; k < 5 && byte + k < br->len; ++k) w |= (uint64_t)br->data[byte + k] << (8 * k);
    return (uint32_t)((w >> (br->pos & 7)) & ((1ull << n) - 1));
}

static uint32_t lbr_read(LBitReader* br, int n) {
    const uint32_t v = lbr_peek(br, n);
    br->pos += n;
    return v;
}

// libwebp's reader ends the stream once more bits were read than the data
// holds (and never before the first 8 bytes' worth)
static int lbr_eos(const LBitReader* br) {
    return br->pos > 8 * (uint64_t)(br->len > 8 ? br->len : 8);
}

typedef struct {
    int single;  // the one symbol of a one-symbol code (read as 0 bits), else -1
    int max_len;
    uint16_t* table;  // (symbol << 4) | length of each TABLE_BITS-bit window
    int count[MAX_CODE_LENGTH + 1];
    int first[MAX_CODE_LENGTH + 1];  // canonical code of each length's first symbol
    int offset[MAX_CODE_LENGTH + 1];
    uint16_t* sorted;
} HuffCode;

static void huff_free(HuffCode* h) {
    free(h->table);
    free(h->sorted);
    h->table = NULL;
    h->sorted = NULL;
}

// A canonical prefix code from its code lengths: 0 when it has no symbol,
// or is incomplete or over-subscribed (one symbol alone is a code of 0 bits).
static int huff_build(HuffCode* h, const int* lengths, int n) {
    memset(h, 0, sizeof(*h));
    h->single = -1;
    int nonzero = 0, last = -1;
    for (int s = 0; s < n; ++s) {
        if (lengths[s] > MAX_CODE_LENGTH) return 0;
        h->count[lengths[s]]++;
        if (lengths[s]) {
            nonzero++;
            last = s;
        }
    }
    if (nonzero == 0) return 0;
    if (nonzero == 1) {
        if (lengths[last] == MAX_CODE_LENGTH) return 0;
        h->single = last;
        return 1;
    }
    uint64_t kraft = 0;
    for (int len = 1; len <= MAX_CODE_LENGTH; ++len) {
        kraft += (uint64_t)h->count[len] << (MAX_CODE_LENGTH - len);
        if (h->count[len]) h->max_len = len;
    }
    if (kraft != (1u << MAX_CODE_LENGTH)) return 0;
    h->sorted = malloc(sizeof(uint16_t) * nonzero);
    h->table = calloc((size_t)1 << TABLE_BITS, sizeof(uint16_t));
    if (!h->sorted || !h->table) return 0;
    int code = 0, off = 0;
    for (int len = 1; len <= MAX_CODE_LENGTH; ++len) {
        h->first[len] = code;
        h->offset[len] = off;
        off += h->count[len];
        code = (code + h->count[len]) << 1;
    }
    int next[MAX_CODE_LENGTH + 1];
    memcpy(next, h->offset, sizeof(next));
    for (int s = 0; s < n; ++s)
        if (lengths[s]) h->sorted[next[lengths[s]]++] = (uint16_t)s;
    for (int len = 1; len <= TABLE_BITS && len <= h->max_len; ++len) {
        for (int i = 0; i < h->count[len]; ++i) {
            const int c = h->first[len] + i;
            int rev = 0;
            for (int b = 0; b < len; ++b) rev |= ((c >> (len - 1 - b)) & 1) << b;
            const int sym = h->sorted[h->offset[len] + i];
            for (int k = rev; k < (1 << TABLE_BITS); k += 1 << len)
                h->table[k] = (uint16_t)((sym << 4) | len);
        }
    }
    return 1;
}

// The symbol the stream bits `bits` (the first the lowest) begin with, and
// its code length in *len.
static int huff_decode(const HuffCode* h, uint64_t bits, int* len) {
    if (h->single >= 0) {
        *len = 0;
        return h->single;
    }
    const uint16_t e = h->table[bits & ((1u << TABLE_BITS) - 1)];
    if (e) {
        *len = e & 15;
        return e >> 4;
    }
    // a code longer than the table: bit by bit, the code's highest bit first
    int code = 0;
    for (int n = 1; n <= h->max_len; ++n) {
        code = (code << 1) | (int)((bits >> (n - 1)) & 1);
        const int k = code - h->first[n];
        if (k >= 0 && k < h->count[n]) {
            *len = n;
            return h->sorted[h->offset[n] + k];
        }
    }
    *len = 0;
    return 0;  // not reached: the code is complete
}

static int huff_read(const HuffCode* h, LBitReader* br) {
    int len;
    const int sym = huff_decode(h, lbr_peek(br, MAX_CODE_LENGTH), &len);
    br->pos += len;
    return sym;
}

typedef struct {
    LBitReader br;
    int transforms_seen;
    int alpha;  // the stream is an ALPH plane's
    int accepted_end;  // the 8-bit alpha path ended it: its own end rule holds
    int error;
} VP8LDec;

static int read_code_lengths(VP8LDec* d, const int* cl_lengths, int num_symbols, int* lengths) {
    LBitReader* br = &d->br;
    HuffCode h;
    int ok = 0;
    if (!huff_build(&h, cl_lengths, 19)) goto end;
    int max_symbol = num_symbols;
    if (lbr_read(br, 1)) {
        const int length_nbits = 2 + 2 * (int)lbr_read(br, 3);
        max_symbol = 2 + (int)lbr_read(br, length_nbits);
        if (max_symbol > num_symbols) goto end;
    }
    int prev = 8;
    for (int symbol = 0; symbol < num_symbols;) {
        if (max_symbol-- == 0) break;
        const int code_len = huff_read(&h, br);
        if (code_len < 16) {
            lengths[symbol++] = code_len;
            if (code_len != 0) prev = code_len;
        } else {
            static const int extra[3] = {2, 3, 7}, offs[3] = {3, 3, 11};
            const int slot = code_len - 16;
            int repeat = (int)lbr_read(br, extra[slot]) + offs[slot];
            if (symbol + repeat > num_symbols) goto end;
            const int length = code_len == 16 ? prev : 0;
            while (repeat-- > 0) lengths[symbol++] = length;
        }
    }
    ok = 1;
end:
    huff_free(&h);
    return ok;
}

static int read_huffman_code(VP8LDec* d, int alphabet, HuffCode* out) {
    LBitReader* br = &d->br;
    int lengths[NUM_LITERAL_CODES + NUM_LENGTH_CODES + (1 << MAX_CACHE_BITS)] = {0};
    if (lbr_read(br, 1)) {  // a simple code: one or two symbols
        const int num_symbols = (int)lbr_read(br, 1) + 1;
        const int first_8bits = (int)lbr_read(br, 1);
        lengths[lbr_read(br, first_8bits ? 8 : 1)] = 1;
        if (num_symbols == 2) lengths[lbr_read(br, 8)] = 1;
    } else {
        int cl_lengths[19] = {0};
        const int num_codes = (int)lbr_read(br, 4) + 4;
        for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = (int)lbr_read(br, 3);
        if (!read_code_lengths(d, cl_lengths, alphabet, lengths)) return 0;
    }
    if (lbr_eos(br)) return 0;
    return huff_build(out, lengths, alphabet);
}

typedef struct {
    HuffCode codes[5];  // green + lengths + cache, red, blue, alpha, distance
} HGroup;

typedef struct {
    int type, bits, xsize;
    uint32_t* data;
} Transform;

static uint32_t* decode_image_stream(VP8LDec* d, int xsize, int ysize, int is_level0,
                                     Transform* transforms, int* num_transforms,
                                     int* out_xsize);

static int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

static int read_transform(VP8LDec* d, int* xsize, int ysize, Transform* t) {
    LBitReader* br = &d->br;
    const int type = (int)lbr_read(br, 2);
    if (d->transforms_seen & (1 << type)) return 0;
    d->transforms_seen |= 1 << type;
    t->type = type;
    t->xsize = *xsize;
    t->data = NULL;
    t->bits = 0;
    if (type == 0 || type == 1) {  // predictor, cross colour
        t->bits = (int)lbr_read(br, 3) + 2;
        t->data = decode_image_stream(d, sub_sample(*xsize, t->bits), sub_sample(ysize, t->bits), 0,
                                      NULL, NULL, NULL);
        return t->data != NULL;
    }
    if (type == 3) {  // colour indexing: the palette, delta-coded
        const int num_colors = (int)lbr_read(br, 8) + 1;
        const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        *xsize = sub_sample(t->xsize, bits);
        t->bits = bits;
        uint32_t* pal = decode_image_stream(d, num_colors, 1, 0, NULL, NULL, NULL);
        if (pal == NULL) return 0;
        const int final = 1 << (8 >> bits);
        t->data = calloc((size_t)final, sizeof(uint32_t));
        if (t->data == NULL) {
            free(pal);
            return 0;
        }
        uint8_t* dst = (uint8_t*)t->data;
        const uint8_t* src = (const uint8_t*)pal;
        memcpy(dst, src, 4);
        for (int i = 4; i < 4 * num_colors; ++i) dst[i] = (uint8_t)(src[i] + dst[i - 4]);
        free(pal);
    }
    return 1;
}

static int copy_distance(int symbol, LBitReader* br) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + (int)lbr_read(br, extra) + 1;
}

static int plane_code_to_distance(int xsize, int plane_code) {
    if (plane_code > 120) return plane_code - 120;
    const int dist_code = kCodeToPlane[plane_code - 1];
    const int yoffset = dist_code >> 4;
    const int xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
}

// --- the alpha plane's 8-bit path -----------------------------------------
//
// libwebp decodes an ALPH plane whose only transform is colour indexing,
// with no colour cache and red, blue and alpha codes of one symbol each, a
// byte a pixel (DecodeAlphaData), and there it accepts a stream that ends
// within its last symbol.  A symbol read past the data takes its bits from
// libwebp's 64-bit window as it then stands, so its reader is repeated here:
// the window holds the eight bytes before `pos`, `bit_pos` counts the bits
// of it read (taken modulo 64), and the end of the stream resets it to 0.

typedef struct {
    const uint8_t* data;
    size_t len, pos;
    uint64_t val;
    int bit_pos, eos;
} LwReader;

// the reader after `bits` bits, loaded as far as the reads before left it
static void lw_init(LwReader* br, const uint8_t* data, size_t len, uint64_t bits) {
    br->data = data;
    br->len = len;
    br->eos = 0;
    if (len < 8) {
        br->pos = len;
        br->bit_pos = (int)bits;
    } else {
        br->pos = (size_t)(bits / 8 + 8) < len ? (size_t)(bits / 8 + 8) : len;
        br->bit_pos = (int)(bits - 8 * (uint64_t)(br->pos - 8));
    }
    br->val = 0;
    const size_t start = br->pos < 8 ? 0 : br->pos - 8;
    for (size_t k = start; k < br->pos; ++k) br->val |= (uint64_t)data[k] << (8 * (k - start));
}

static int lw_is_eos(const LwReader* br) {
    return br->eos || (br->pos == br->len && br->bit_pos > 64);
}

static void lw_shift_bytes(LwReader* br) {
    while (br->bit_pos >= 8 && br->pos < br->len) {
        br->val = (br->val >> 8) | ((uint64_t)br->data[br->pos++] << 56);
        br->bit_pos -= 8;
    }
    if (lw_is_eos(br)) {
        br->eos = 1;
        br->bit_pos = 0;
    }
}

static void lw_fill(LwReader* br) {
    if (br->bit_pos < 32) return;
    if (br->pos + 8 < br->len) {
        uint32_t next;
        memcpy(&next, br->data + br->pos, 4);  // little-endian hosts
        br->val = (br->val >> 32) | ((uint64_t)next << 32);
        br->bit_pos -= 32;
        br->pos += 4;
    } else {
        lw_shift_bytes(br);
    }
}

static uint32_t lw_prefetch(const LwReader* br) {
    return (uint32_t)(br->val >> (br->bit_pos & 63));
}

static uint32_t lw_read_bits(LwReader* br, int n) {
    if (br->eos || n > 24) {
        br->eos = 1;
        br->bit_pos = 0;
        return 0;
    }
    const uint32_t v = lw_prefetch(br) & ((1u << n) - 1);
    br->bit_pos += n;
    lw_shift_bytes(br);
    return v;
}

// libwebp's ReadSymbol: an 8-bit root table, then a second look-up at the
// position 8 bits on for a longer code
static int lw_read_symbol(const HuffCode* h, LwReader* br) {
    int len;
    const uint32_t first = lw_prefetch(br);
    int sym = huff_decode(h, first, &len);
    if (len > 8) {
        br->bit_pos += 8;
        sym = huff_decode(h, (first & 0xff) | ((uint64_t)lw_prefetch(br) << 8), &len);
        len -= 8;
    }
    br->bit_pos += len;
    return sym;
}

static int lw_copy_distance(int symbol, LwReader* br) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    return ((2 + (symbol & 1)) << extra) + (int)lw_read_bits(br, extra) + 1;
}

// DecodeAlphaData: the green bytes of `width` x `height` pixels into
// data's green channel, read from where the header left d->br
static int decode_alpha8(VP8LDec* d, const HGroup* groups, const uint32_t* huff_image,
                         int huff_bits, int huff_xsize, int width, int height, uint32_t* data) {
    LwReader br;
    lw_init(&br, d->br.data, d->br.len, d->br.pos);
    const int end = width * height;
    const int mask = huff_image ? (1 << huff_bits) - 1 : ~0;
    int pos = 0, col = 0, row = 0;
    const HGroup* grp = groups;
    while (!br.eos && pos < end) {
        if ((col & mask) == 0 && huff_image)
            grp = groups + huff_image[(row >> huff_bits) * huff_xsize + (col >> huff_bits)];
        lw_fill(&br);
        const int code = lw_read_symbol(&grp->codes[0], &br);
        if (code < NUM_LITERAL_CODES) {
            data[pos++] = (uint32_t)code << 8;
            if (++col >= width) {
                col = 0;
                ++row;
            }
        } else {
            const int length = lw_copy_distance(code - NUM_LITERAL_CODES, &br);
            const int dist_symbol = lw_read_symbol(&grp->codes[4], &br);
            lw_fill(&br);
            const int dist = plane_code_to_distance(width, lw_copy_distance(dist_symbol, &br));
            if (pos < dist || end - pos < length) return VP8L_BAD_DISTANCE;
            for (int k = 0; k < length; ++k, ++pos) data[pos] = data[pos - dist];
            col += length;
            while (col >= width) {
                col -= width;
                ++row;
            }
            if (pos < end && (col & mask) && huff_image)
                grp = groups + huff_image[(row >> huff_bits) * huff_xsize + (col >> huff_bits)];
        }
        br.eos = lw_is_eos(&br);
    }
    return lw_is_eos(&br) && pos < end ? VP8L_TRUNCATED : WEBP_OK;
}

// The entropy-coded pixels of one image (transforms, colour cache and
// prefix codes read first).  Level 0 (the main image, or the alpha plane)
// reads the transforms and may use meta prefix codes; the sub-images
// (transform data, the entropy image, the palette) do neither.  Returns the
// xsize x ysize ARGB pixels (malloc'd; NULL on a fault, in d->error), the
// width after a colour-indexing transform in *out_xsize.
static uint32_t* decode_image_stream(VP8LDec* d, int xsize, int ysize, int is_level0,
                                     Transform* transforms, int* num_transforms,
                                     int* out_xsize) {
    LBitReader* br = &d->br;
    int txsize = xsize;
    uint32_t* data = NULL;
    uint32_t* huff_image = NULL;
    uint32_t* cache = NULL;
    HGroup* groups = NULL;
    int num_groups = 1, huff_bits = 0, huff_xsize = 0;
    if (is_level0) {
        while (lbr_read(br, 1)) {
            // each of the four types at most once: a fifth repeats one
            if (*num_transforms == 4
                || !read_transform(d, &txsize, ysize, &transforms[*num_transforms])) {
                if (!d->error) d->error = VP8L_BAD_TRANSFORM;
                return NULL;
            }
            ++*num_transforms;
        }
        *out_xsize = txsize;
    }
    int cache_bits = 0;
    if (lbr_read(br, 1)) {
        cache_bits = (int)lbr_read(br, 4);
        if (cache_bits < 1 || cache_bits > MAX_CACHE_BITS) {
            d->error = VP8L_BAD_CACHE_BITS;
            return NULL;
        }
    }
    if (is_level0 && lbr_read(br, 1)) {  // meta prefix codes: the entropy image
        huff_bits = (int)lbr_read(br, 3) + 2;
        huff_xsize = sub_sample(txsize, huff_bits);
        const int huff_ysize = sub_sample(ysize, huff_bits);
        huff_image = decode_image_stream(d, huff_xsize, huff_ysize, 0, NULL, NULL, NULL);
        if (huff_image == NULL) goto fail;
        for (int i = 0; i < huff_xsize * huff_ysize; ++i) {
            huff_image[i] = (huff_image[i] >> 8) & 0xffff;
            if ((int)huff_image[i] >= num_groups) num_groups = (int)huff_image[i] + 1;
        }
    }
    if (lbr_eos(br)) {
        d->error = VP8L_TRUNCATED;
        goto fail;
    }
    groups = calloc((size_t)num_groups, sizeof(HGroup));
    if (groups == NULL) {
        d->error = WEBP_NO_MEMORY;
        goto fail;
    }
    const int cache_size = cache_bits > 0 ? 1 << cache_bits : 0;
    static const int kAlphabet[5] = {NUM_LITERAL_CODES + NUM_LENGTH_CODES, NUM_LITERAL_CODES,
                                     NUM_LITERAL_CODES, NUM_LITERAL_CODES, NUM_DISTANCE_CODES};
    for (int g = 0; g < num_groups; ++g)
        for (int j = 0; j < 5; ++j)
            if (!read_huffman_code(d, kAlphabet[j] + (j == 0 ? cache_size : 0),
                                   &groups[g].codes[j])) {
                d->error = lbr_eos(br) ? VP8L_TRUNCATED : VP8L_BAD_CODE;
                goto fail;
            }
    data = malloc(sizeof(uint32_t) * (size_t)txsize * ysize);
    if (cache_size) cache = calloc((size_t)cache_size, sizeof(uint32_t));
    if (data == NULL || (cache_size && cache == NULL)) {
        d->error = WEBP_NO_MEMORY;
        goto fail;
    }
    int alpha8 = is_level0 && d->alpha && *num_transforms == 1 && transforms[0].type == 3
                 && cache_size == 0;
    for (int g = 0; g < num_groups && alpha8; ++g)
        for (int j = 1; j < 4; ++j) alpha8 &= groups[g].codes[j].single >= 0;
    if (alpha8) {
        const int err = decode_alpha8(d, groups, huff_image, huff_bits, huff_xsize, txsize, ysize,
                                      data);
        if (err) {
            d->error = err;
            goto fail;
        }
        d->accepted_end = 1;
        goto done;
    }
    {
        const int total = txsize * ysize;
        const int len_limit = NUM_LITERAL_CODES + NUM_LENGTH_CODES;
        const int cache_shift = 32 - cache_bits;
        int pos = 0;
        while (pos < total) {
            const int col = pos % txsize, row = pos / txsize;
            const HGroup* grp = groups;
            if (huff_image)
                grp += huff_image[(row >> huff_bits) * huff_xsize + (col >> huff_bits)];
            const int code = huff_read(&grp->codes[0], br);
            if (code < NUM_LITERAL_CODES) {
                const int red = huff_read(&grp->codes[1], br);
                const int blue = huff_read(&grp->codes[2], br);
                const int alpha = huff_read(&grp->codes[3], br);
                data[pos] = ((uint32_t)alpha << 24) | (red << 16) | (code << 8) | blue;
                if (cache) cache[(0x1e35a7bdu * data[pos]) >> cache_shift] = data[pos];
                pos++;
            } else if (code < len_limit) {
                const int length = copy_distance(code - NUM_LITERAL_CODES, br);
                const int dist_symbol = huff_read(&grp->codes[4], br);
                const int dist = plane_code_to_distance(txsize, copy_distance(dist_symbol, br));
                if (lbr_eos(br)) break;
                if (pos < dist || total - pos < length) {
                    d->error = VP8L_BAD_DISTANCE;
                    goto fail;
                }
                for (int k = 0; k < length; ++k, ++pos) {
                    data[pos] = data[pos - dist];
                    if (cache) cache[(0x1e35a7bdu * data[pos]) >> cache_shift] = data[pos];
                }
            } else {
                data[pos] = cache[code - len_limit];
                cache[(0x1e35a7bdu * data[pos]) >> cache_shift] = data[pos];
                pos++;
            }
            if (lbr_eos(br)) break;
        }
        if (lbr_eos(br)) {
            d->error = VP8L_TRUNCATED;
            goto fail;
        }
    }
    goto done;
fail:
    free(data);
    data = NULL;
done:
    if (groups)
        for (int g = 0; g < num_groups; ++g)
            for (int j = 0; j < 5; ++j) huff_free(&groups[g].codes[j]);
    free(groups);
    free(huff_image);
    free(cache);
    return data;
}

static uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

static int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

static uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {  // a: top, b: left, c: top-left
    int sum = 0;
    for (int s = 0; s < 32; s += 8) {
        const int ca = (a >> s) & 0xff, cb = (b >> s) & 0xff, cc = (c >> s) & 0xff;
        sum += abs(cb - cc) - abs(ca - cc);
    }
    return sum <= 0 ? a : b;
}

static uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
        out |= (uint32_t)clip255((int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff)
                                 - (int)((c2 >> s) & 0xff)) << s;
    return out;
}

static uint32_t add_sub_half(uint32_t c0, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int a = (c0 >> s) & 0xff, b = (c2 >> s) & 0xff;
        out |= (uint32_t)clip255(a + (a - b) / 2) << s;
    }
    return out;
}

static uint32_t predict(int mode, const uint32_t* out, int x, int width) {
    const uint32_t L = out[x - 1];
    const uint32_t* up = out + x - width;
    switch (mode) {
    case 1: return L;
    case 2: return up[0];
    case 3: return up[1];
    case 4: return up[-1];
    case 5: return average2(average2(L, up[1]), up[0]);
    case 6: return average2(L, up[-1]);
    case 7: return average2(L, up[0]);
    case 8: return average2(up[-1], up[0]);
    case 9: return average2(up[0], up[1]);
    case 10: return average2(average2(L, up[-1]), average2(up[0], up[1]));
    case 11: return select_pred(up[0], L, up[-1]);
    case 12: return add_sub_full(L, up[0], up[-1]);
    case 13: return add_sub_half(average2(L, up[0]), up[-1]);
    default: return 0xff000000u;  // 0, and 14-15
    }
}

static uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

static int color_delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

// Undo one transform: `in` (xsize' x height, xsize' the width the transform
// was read at or, for colour indexing, the packed width) into `out`
// (t->xsize x height); they may be the same buffer except for colour indexing.
static void inverse_transform(const Transform* t, int height, const uint32_t* in, uint32_t* out) {
    const int width = t->xsize;
    if (t->type == 2) {  // subtract green
        for (size_t i = 0; i < (size_t)width * height; ++i) {
            const uint32_t argb = in[i], green = (argb >> 8) & 0xff;
            const uint32_t rb = ((argb & 0x00ff00ffu) + ((green << 16) | green)) & 0x00ff00ffu;
            out[i] = (argb & 0xff00ff00u) | rb;
        }
    } else if (t->type == 0) {  // predictor
        const int tiles = sub_sample(width, t->bits);
        for (int y = 0; y < height; ++y) {
            const uint32_t* row_in = in + (size_t)y * width;
            uint32_t* row = out + (size_t)y * width;
            const uint32_t* modes = t->data + (size_t)(y >> t->bits) * tiles;
            for (int x = 0; x < width; ++x) {
                uint32_t pred;
                if (y == 0) pred = x == 0 ? 0xff000000u : row[x - 1];
                else if (x == 0) pred = row[-width];
                else pred = predict((modes[x >> t->bits] >> 8) & 0xf, row, x, width);
                row[x] = add_pixels(row_in[x], pred);
            }
        }
    } else if (t->type == 1) {  // cross colour
        const int tiles = sub_sample(width, t->bits);
        for (int y = 0; y < height; ++y) {
            const uint32_t* m = t->data + (size_t)(y >> t->bits) * tiles;
            for (int x = 0; x < width; ++x) {
                const uint32_t code = m[x >> t->bits];
                const int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff);
                const int8_t r2b = (int8_t)((code >> 16) & 0xff);
                const size_t i = (size_t)y * width + x;
                const uint32_t argb = in[i];
                const int8_t green = (int8_t)(argb >> 8);
                int new_red = (argb >> 16) & 0xff, new_blue = argb & 0xff;
                new_red = (new_red + color_delta(g2r, green)) & 0xff;
                new_blue += color_delta(g2b, green);
                new_blue = (new_blue + color_delta(r2b, (int8_t)new_red)) & 0xff;
                out[i] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | (uint32_t)new_blue;
            }
        }
    } else {  // colour indexing, several indices a pixel when bits > 0
        const int bits_per_pixel = 8 >> t->bits;
        const int count_mask = (1 << t->bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        const int packed_width = sub_sample(width, t->bits);
        for (int y = height - 1; y >= 0; --y) {  // bottom up: `out` may hold `in`
            const uint32_t* src = in + (size_t)y * packed_width;
            uint32_t* dst = out + (size_t)y * width;
            for (int x = width - 1; x >= 0; --x) {
                const uint32_t packed = (src[x >> t->bits] >> 8) & 0xff;
                const int shift = (x & count_mask) * bits_per_pixel;
                dst[x] = t->data[(packed >> shift) & bit_mask];
            }
        }
    }
}

// A level-0 stream (after the header, or an alpha plane's) decoded and its
// transforms undone: width x height ARGB into `argb`.
static int decode_level0(const uint8_t* data, size_t size, int width, int height, uint32_t* argb,
                         int skip_bits, int alpha) {
    VP8LDec d = {{data, size, (uint64_t)skip_bits}, 0, alpha, 0, 0};
    Transform transforms[4] = {{0}};
    int num_transforms = 0, xsize = width;
    uint32_t* pixels = decode_image_stream(&d, width, height, 1, transforms, &num_transforms,
                                           &xsize);
    int err = d.error;
    if (pixels == NULL && !err) err = VP8L_BAD_CODE;
    if (pixels != NULL && !d.accepted_end && lbr_eos(&d.br)) err = VP8L_TRUNCATED;
    if (!err) {
        // undo the transforms last to first; a packed (colour-indexed) image
        // is narrower than `argb`, so it is copied in first
        memcpy(argb, pixels, sizeof(uint32_t) * (size_t)xsize * height);
        for (int n = num_transforms - 1; n >= 0; --n) inverse_transform(&transforms[n], height,
                                                                        argb, argb);
    }
    free(pixels);
    for (int n = 0; n < num_transforms; ++n) free(transforms[n].data);
    return err;
}

// A VP8L image: the chunk's payload (and whatever follows it in the file)
// with its 5-byte header, which must give width x height; ARGB out.
int vp8l_decode(const uint8_t* data, int64_t size, int width, int height, uint32_t* argb) {
    if (size < 5 || data[0] != 0x2f) return VP8L_BAD_HEADER;
    LBitReader br = {data, (size_t)size, 8};
    const int w = (int)lbr_read(&br, 14) + 1, h = (int)lbr_read(&br, 14) + 1;
    lbr_read(&br, 1);  // alpha is used (the container reads it)
    if (lbr_read(&br, 3) != 0) return VP8L_BAD_HEADER;
    if (w != width || h != height) return VP8L_BAD_SIZE;
    return decode_level0(data, (size_t)size, width, height, argb, (int)br.pos, 0);
}

// ---------------------------------------------------------------------------
// ALPH: the alpha plane of a lossy image (libwebp's alpha_dec.c)
// ---------------------------------------------------------------------------

static uint8_t gradient_pred(uint8_t a, uint8_t b, uint8_t c) {
    const int g = a + b - c;
    return (uint8_t)((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255);
}

// one row unfiltered in place: prev the row above (NULL for the first)
static void unfilter_row(int filter, const uint8_t* prev, uint8_t* row, int width) {
    if (filter == 1 || (prev == NULL && filter != 0)) {  // horizontal
        uint8_t pred = prev == NULL ? 0 : prev[0];
        for (int i = 0; i < width; ++i) {
            row[i] = (uint8_t)(pred + row[i]);
            pred = row[i];
        }
    } else if (filter == 2) {  // vertical
        for (int i = 0; i < width; ++i) row[i] = (uint8_t)(prev[i] + row[i]);
    } else if (filter == 3) {  // gradient
        uint8_t top = prev[0], top_left = top, left = top;
        for (int i = 0; i < width; ++i) {
            top = prev[i];
            left = (uint8_t)(row[i] + gradient_pred(left, top, top_left));
            top_left = top;
            row[i] = left;
        }
    }
}

// An ALPH chunk's payload (its header byte first) as width x height alpha.
int alpha_decode(const uint8_t* data, int64_t size, int width, int height, uint8_t* alpha) {
    if (size <= 1) return ALPH_BAD_HEADER;
    const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
    const int pre_processing = (data[0] >> 4) & 3, reserved = data[0] >> 6;
    if (method > 1 || pre_processing > 1 || reserved != 0) return ALPH_BAD_HEADER;
    const size_t n = (size_t)width * height;
    if (method == 0) {
        if ((size_t)size - 1 < n) return ALPH_TRUNCATED;
        memcpy(alpha, data + 1, n);
    } else {
        uint32_t* argb = malloc(sizeof(uint32_t) * n);
        if (argb == NULL) return WEBP_NO_MEMORY;
        const int err = decode_level0(data + 1, (size_t)size - 1, width, height, argb, 0, 1);
        for (size_t i = 0; !err && i < n; ++i) alpha[i] = (uint8_t)(argb[i] >> 8);
        free(argb);
        if (err) return err;
    }
    // level reduction (pre_processing 1) leaves the decoder nothing to do
    if (filter != 0)
        for (int y = 0; y < height; ++y)
            unfilter_row(filter, y ? alpha + (size_t)(y - 1) * width : NULL,
                         alpha + (size_t)y * width, width);
    return WEBP_OK;
}
