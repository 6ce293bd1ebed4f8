// Native GF(2) batch kernels for LDPC encoding.
//
// Native counterpart of the reference's Cython extension
// (Discrete_LDPC_decoding/GF2MatrixMul_c.pyx): sparse GF(2) mat-vec and
// triangular substitution by column-wise XOR flips. Redesigned for batches:
// each row's value for a whole batch of codewords is a contiguous vector of
// 64-bit words (one bit per codeword), so every column step XORs whole words
// instead of the reference's one-bit-per-call flips.
//
// Build: g++ -O3 -shared -fPIC -o libgf2kernels.so gf2kernels.cpp
// Loaded via ctypes (informationbottleneckdecodingldpc_tpu/utils/native.py).

#include <cstdint>
#include <cstring>

extern "C" {

// dst[rows(col)] ^= src[col] for every column of a CSC matrix.
// Used for s = A * u over GF(2): src is the packed info-bit matrix
// [n_cols, words], dst the packed accumulator [n_rows, words].
void gf2_accumulate_batch(
    int64_t n_cols,
    const int32_t* indptr,   // [n_cols + 1]
    const int32_t* indices,  // row indices
    const uint64_t* src,     // [n_cols, words]
    uint64_t* dst,           // [n_rows, words]
    int64_t words) {
  for (int64_t c = 0; c < n_cols; ++c) {
    const uint64_t* s = src + c * words;
    bool any = false;
    for (int64_t w = 0; w < words; ++w) any |= (s[w] != 0);
    if (!any) continue;
    for (int32_t k = indptr[c]; k < indptr[c + 1]; ++k) {
      uint64_t* d = dst + (int64_t)indices[k] * words;
      for (int64_t w = 0; w < words; ++w) d[w] ^= s[w];
    }
  }
}

// In-place triangular substitution: solve (I + S) y = b where S is the
// strictly-triangular part given as CSC. direction=+1 walks columns forward
// (S strictly lower), -1 backward (S strictly upper). data[col] holds b on
// entry and y on exit, exactly the reference's in-place scheme
// (LDPC_encoder.py:164-190) but one word-vector per row.
void gf2_substitute_batch(
    int64_t n,
    const int32_t* indptr,
    const int32_t* indices,
    uint64_t* data,  // [n, words]
    int64_t words,
    int direction) {
  int64_t c = (direction == 1) ? 0 : n - 1;
  for (int64_t step = 0; step < n; ++step, c += direction) {
    const uint64_t* s = data + c * words;
    bool any = false;
    for (int64_t w = 0; w < words; ++w) any |= (s[w] != 0);
    if (!any) continue;
    for (int32_t k = indptr[c]; k < indptr[c + 1]; ++k) {
      uint64_t* d = data + (int64_t)indices[k] * words;
      for (int64_t w = 0; w < words; ++w) d[w] ^= s[w];
    }
  }
}

// Packed syndrome: out[row] = XOR over H's row entries of codeword bits.
// H passed as CSR. Used for encode verification (H c = 0).
void gf2_syndrome_batch(
    int64_t n_rows,
    const int32_t* indptr,
    const int32_t* indices,
    const uint64_t* codeword,  // [n_cols, words]
    uint64_t* out,             // [n_rows, words]
    int64_t words) {
  for (int64_t r = 0; r < n_rows; ++r) {
    uint64_t* o = out + r * words;
    std::memset(o, 0, (size_t)words * sizeof(uint64_t));
    for (int32_t k = indptr[r]; k < indptr[r + 1]; ++k) {
      const uint64_t* c = codeword + (int64_t)indices[k] * words;
      for (int64_t w = 0; w < words; ++w) o[w] ^= c[w];
    }
  }
}

}  // extern "C"
