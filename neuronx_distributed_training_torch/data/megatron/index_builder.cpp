// Sample-index builder for mmap GPT datasets (a copy of the JAX package's
// data/megatron/index_builder.cpp; host code, not a device kernel).
//
// Counterpart of the Megatron-core `helpers` C++ extension.  The hot loop:
// walk shuffled documents token-by-token and emit one
// (doc_idx_index, doc_offset) pair per training sample of `seq_length` tokens.
// Python/numpy does this in minutes for trillion-token corpora; this loop does
// it in seconds.  Exposed extern "C" for ctypes.
//
// Built at first use by data/_native.py into build/torch_native/ at the repo
// root: c++ -O3 -shared -fPIC index_builder.cpp -o libindex_builder-<digest>.so

#include <cstdint>

extern "C" {

// sample_idx out buffer must hold (num_samples + 1) * 2 int64s.
// doc_lens[i] is the token length of document doc_idx[i] (already shuffled
// order).  Returns the number of samples actually emitted (== num_samples
// unless the corpus runs out, which the caller sizes against).
int64_t build_sample_idx(const int32_t* doc_lens,
                         const int32_t* doc_idx,
                         int64_t num_docs,
                         int64_t num_samples,
                         int64_t seq_length,
                         int64_t* sample_idx /* out */) {
  int64_t sample = 0;
  int64_t doc_cursor = 0;     // index into doc_idx
  int64_t doc_offset = 0;     // token offset inside current document
  sample_idx[0] = doc_cursor;
  sample_idx[1] = doc_offset;
  // +1 token: each sample needs seq_length + 1 tokens (input + shifted label)
  while (sample < num_samples) {
    int64_t remaining = seq_length + 1;
    while (remaining > 0) {
      if (doc_cursor >= num_docs) {
        return sample;  // corpus exhausted
      }
      int64_t doc_len = doc_lens[doc_idx[doc_cursor]] - doc_offset;
      if (doc_len >= remaining) {
        // boundary stays INSIDE this doc even on exact fill (offset = len-1):
        // the boundary token is shared between consecutive samples (Megatron
        // semantics; keeps every sample exactly seq_length+1 tokens)
        doc_offset += remaining - 1;
        remaining = 0;
      } else {
        remaining -= doc_len;
        ++doc_cursor;
        doc_offset = 0;
      }
    }
    ++sample;
    sample_idx[2 * sample] = doc_cursor;
    sample_idx[2 * sample + 1] = doc_offset;
  }
  return sample;
}

}  // extern "C"
