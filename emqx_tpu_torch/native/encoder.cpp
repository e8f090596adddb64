// Native topic encoder: tokenize publish topics and look their words
// up in the NFA vocab, at C speed.  The port's copy of the reference's
// emqx_tpu/native/encoder.cpp, with the same code.
//
// Contract (the same output as the Python path of ops/encode.py):
//   * topics arrive as one uint8 buffer, '\0'-separated (MQTT forbids
//     U+0000 in topics, so the separator is unambiguous);
//   * words[r, i] = vocab id of level i (0 = UNKNOWN) for i < D;
//   * lens[r]     = min(n_levels, D + 1);
//   * is_sys[r]   = 1 when the first byte is '$'.
// Padding rows beyond n_topics are left to the caller.
//
// The vocab is pushed incrementally (append-only, matching the tables'
// interning): enc_add_words() extends the table without rebuilding it.
//
// C ABI only, bound with ctypes (emqx_tpu_torch/ops/encode.py); built by
// emqx_tpu_torch/native/build.py at first use.

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>

namespace {

struct SvHash {
    using is_transparent = void;
    size_t operator()(std::string_view sv) const noexcept {
        return std::hash<std::string_view>{}(sv);
    }
};
struct SvEq {
    using is_transparent = void;
    bool operator()(std::string_view a, std::string_view b) const noexcept {
        return a == b;
    }
};

struct Encoder {
    std::unordered_map<std::string, int32_t, SvHash, SvEq> vocab;
};

}  // namespace

extern "C" {

void* enc_new() { return new Encoder(); }

void enc_free(void* h) { delete static_cast<Encoder*>(h); }

// words: '\0'-separated word bytes; ids: parallel int32 vocab ids.
void enc_add_words(void* h, const uint8_t* buf, int64_t buflen,
                   const int32_t* ids, int32_t n) {
    auto* enc = static_cast<Encoder*>(h);
    const char* p = reinterpret_cast<const char*>(buf);
    const char* end = p + buflen;
    for (int32_t k = 0; k < n && p <= end; ++k) {
        const char* q = static_cast<const char*>(memchr(p, '\0', end - p));
        size_t len = q ? static_cast<size_t>(q - p)
                       : static_cast<size_t>(end - p);
        enc->vocab.emplace(std::string(p, len), ids[k]);
        p += len + 1;
    }
}

int64_t enc_vocab_size(void* h) {
    return static_cast<int64_t>(static_cast<Encoder*>(h)->vocab.size());
}

// Encode n_topics '\0'-separated topics.  Returns n_topics on success;
// -1 when the buffer does not parse into EXACTLY n_topics segments
// consuming every byte (e.g. a topic smuggled a NUL — MQTT forbids it,
// but a row shift here would corrupt OTHER topics' answers, so the
// caller falls back to the Python path for the whole batch).
// words_out is (n_topics, depth) int32 row-major, zero-initialized by
// the caller; lens_out (n_topics,) int32; is_sys_out (n_topics,) uint8.
int32_t enc_encode(void* h, const uint8_t* buf, int64_t buflen,
                   int32_t n_topics, int32_t depth,
                   int32_t* words_out, int32_t* lens_out,
                   uint8_t* is_sys_out) {
    auto* enc = static_cast<Encoder*>(h);
    const char* p = reinterpret_cast<const char*>(buf);
    const char* end = p + buflen;
    int32_t r = 0;
    bool consumed = (buflen == 0);
    while (r < n_topics) {
        const char* tend = static_cast<const char*>(
            memchr(p, '\0', end - p));
        if (tend == nullptr) tend = end;
        is_sys_out[r] = (p < tend && *p == '$') ? 1 : 0;
        int32_t nlevels = 0;
        const char* w = p;
        int32_t* row = words_out + static_cast<int64_t>(r) * depth;
        while (w <= tend) {
            const char* wend = static_cast<const char*>(
                memchr(w, '/', tend - w));
            if (wend == nullptr) wend = tend;
            if (nlevels < depth) {
#if defined(__cpp_lib_generic_unordered_lookup)
                auto it = enc->vocab.find(
                    std::string_view(w, static_cast<size_t>(wend - w)));
#else
                // libstdc++ < 11: no heterogeneous unordered lookup
                auto it = enc->vocab.find(
                    std::string(w, static_cast<size_t>(wend - w)));
#endif
                row[nlevels] = (it != enc->vocab.end()) ? it->second : 0;
            }
            ++nlevels;
            if (wend == tend) break;
            w = wend + 1;
        }
        lens_out[r] = nlevels < depth + 1 ? nlevels : depth + 1;
        ++r;
        if (tend == end) { consumed = true; break; }
        p = tend + 1;
    }
    return (r == n_topics && consumed) ? r : -1;
}

}  // extern "C"
