// janitor_util — C++ fast path for n-gram decontamination text processing.
//
// Native equivalent of the pybind11 extension the reference declares but
// does not ship (the reference's `lm_eval/decontamination/janitor.py:8-17`;
// SURVEY.md §2.6 item 4). Exposed through a plain C ABI and loaded with
// ctypes (no pybind11 needed), with a pure-Python fallback in
// `decontamination/janitor.py`. A copy of the JAX package's
// `native/janitor_util.cpp`; host code, not a device kernel.
//
// Build (`decontamination/janitor.py` does it at first use, into `_build/`):
//   g++ -O3 -shared -fPIC -o janitor_util.so janitor_util.cpp

#include <cctype>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Lowercase and replace non-alphanumeric with spaces (the reference
// janitor's normalization), collapsing runs of separators.
std::string clean(const char* text, size_t len) {
    std::string out;
    out.reserve(len);
    bool last_space = true;
    for (size_t i = 0; i < len; ++i) {
        unsigned char c = static_cast<unsigned char>(text[i]);
        if (std::isalnum(c)) {
            out.push_back(static_cast<char>(std::tolower(c)));
            last_space = false;
        } else if (!last_space) {
            out.push_back(' ');
            last_space = true;
        }
    }
    if (!out.empty() && out.back() == ' ') out.pop_back();
    return out;
}

std::vector<std::string> split_words(const std::string& s) {
    std::vector<std::string> words;
    size_t start = 0;
    while (start < s.size()) {
        size_t end = s.find(' ', start);
        if (end == std::string::npos) end = s.size();
        if (end > start) words.emplace_back(s, start, end - start);
        start = end + 1;
    }
    return words;
}

}  // namespace

extern "C" {

// Normalize text in place semantics: writes cleaned text into out (caller
// allocates >= len+1). Returns written length.
size_t janitor_clean_text(const char* text, size_t len, char* out) {
    std::string c = clean(text, len);
    std::memcpy(out, c.data(), c.size());
    out[c.size()] = '\0';
    return c.size();
}

// Write all word n-grams of cleaned text into out ('\n'-separated).
// Returns written length (excluding NUL); out must hold ~n*len bytes.
size_t janitor_word_ngrams(const char* text, size_t len, int n, char* out,
                           size_t out_cap) {
    std::string c = clean(text, len);
    std::vector<std::string> words = split_words(c);
    std::string result;
    result.reserve(c.size() * (n > 0 ? n : 1));
    if (n > 0 && words.size() >= static_cast<size_t>(n)) {
        for (size_t i = 0; i + n <= words.size(); ++i) {
            for (int j = 0; j < n; ++j) {
                result += words[i + j];
                if (j + 1 < n) result.push_back(' ');
            }
            result.push_back('\n');
        }
        if (!result.empty()) result.pop_back();
    }
    size_t wlen = result.size() < out_cap - 1 ? result.size() : out_cap - 1;
    std::memcpy(out, result.data(), wlen);
    out[wlen] = '\0';
    return wlen;
}

// Count occurrences of any of the registered contaminant n-grams (joined
// by '\n' in `grams`) inside `text` (cleaned), using simple substring
// search over the cleaned text with word-boundary anchoring.
size_t janitor_count_contaminated(const char* text, size_t len,
                                  const char* grams, size_t grams_len) {
    std::string c = " " + clean(text, len) + " ";
    size_t count = 0;
    size_t start = 0;
    const std::string g(grams, grams_len);
    while (start < g.size()) {
        size_t end = g.find('\n', start);
        if (end == std::string::npos) end = g.size();
        if (end > start) {
            std::string needle = " " + g.substr(start, end - start) + " ";
            for (size_t pos = c.find(needle); pos != std::string::npos;
                 pos = c.find(needle, pos + 1)) {
                ++count;
            }
        }
        start = end + 1;
    }
    return count;
}

}  // extern "C"
