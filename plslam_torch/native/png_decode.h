// A PNG decoder with its own zlib inflate, for hosts without libpng.
//
// It reads what the dataset loader asks of libpng: the five row filters,
// bit depths 1/2/4/8/16, gray, gray+alpha, RGB, RGBA and palette images,
// Adam7 interlacing, several IDAT chunks, chunk CRCs and the zlib stream's
// Adler-32. Samples come out as libpng gives them with
// png_set_palette_to_rgb, png_set_expand_gray_1_2_4_to_8 and
// png_set_tRNS_to_alpha: palette -> RGB (8 bit), gray below 8 bit scaled to
// 8 bit, a tRNS chunk -> an alpha channel; 16-bit samples are read
// big-endian.

#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace plslam_png {

// Inflates a zlib stream (RFC 1950/1951: stored, fixed- and dynamic-Huffman
// blocks, Adler-32 checked; a preset dictionary is refused). Output beyond
// `limit` bytes is an error. Returns false on any malformed or truncated
// input.
bool inflate_zlib(const uint8_t* data, size_t size, std::vector<uint8_t>& out,
                  size_t limit);

// Decodes a PNG held in memory into w * h * channels samples (row-major,
// channels interleaved), each 8 or 16 bits wide (`bit_depth`).
bool decode_memory(const uint8_t* data, size_t size, std::vector<uint16_t>& out,
                   int& w, int& h, int& channels, int& bit_depth);

// decode_memory of a file's bytes.
bool decode_file(const std::string& path, std::vector<uint16_t>& out, int& w,
                 int& h, int& channels, int& bit_depth);

}  // namespace plslam_png
