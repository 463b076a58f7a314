// Greedy sequence packer: the native loop of data/packing.py
// pack_sequences (+eos per record, a new chunk when the next record does not
// fit, records longer than a chunk dropped).  Two passes, so the caller
// allocates exactly n_chunks rows:
//
//   pack_count(lens, n, chunk)            -> number of chunks
//   pack_fill(tokens, labels, offsets, n, chunk, eos, pad, ignore,
//             out_ids, out_lbl)           -> chunks written
//
// lens[i] and offsets[] describe records WITHOUT the eos (added here).

#include <cstdint>

extern "C" {

int64_t pack_count(const int32_t* lens, int64_t n, int64_t chunk_size) {
    int64_t chunks = 0;
    int64_t cur = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t need = static_cast<int64_t>(lens[i]) + 1;  // +eos
        if (need > chunk_size) continue;  // overflow record dropped
        if (cur + need > chunk_size) {
            if (cur > 0) ++chunks;
            cur = 0;
        }
        cur += need;
    }
    if (cur > 0) ++chunks;
    return chunks;
}

int64_t pack_fill(const int32_t* tokens, const int32_t* labels,
                  const int64_t* offsets, int64_t n, int64_t chunk_size,
                  int32_t eos_id, int32_t pad_id, int32_t ignore_index,
                  int32_t* out_ids, int32_t* out_lbl) {
    int64_t chunk = 0;
    int64_t cur = 0;  // fill position within the current chunk

    auto pad_tail = [&]() {
        if (cur == 0) return;
        int32_t* ids = out_ids + chunk * chunk_size;
        int32_t* lbl = out_lbl + chunk * chunk_size;
        for (int64_t j = cur; j < chunk_size; ++j) {
            ids[j] = pad_id;
            lbl[j] = ignore_index;
        }
        ++chunk;
        cur = 0;
    };

    for (int64_t i = 0; i < n; ++i) {
        int64_t start = offsets[i];
        int64_t len = offsets[i + 1] - start;
        int64_t need = len + 1;
        if (need > chunk_size) continue;
        if (cur + need > chunk_size) pad_tail();
        int32_t* ids = out_ids + chunk * chunk_size + cur;
        int32_t* lbl = out_lbl + chunk * chunk_size + cur;
        for (int64_t j = 0; j < len; ++j) {
            ids[j] = tokens[start + j];
            lbl[j] = labels[start + j];
        }
        ids[len] = eos_id;
        lbl[len] = eos_id;
        cur += need;
    }
    pad_tail();
    return chunk;
}

}  // extern "C"
