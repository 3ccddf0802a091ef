// Fast English caption tokenizer — C++ twin of
// imagecaptioner_tpu_torch/data/tokenizer.py's tokenize_py
// (spaCy-lowercase approximation); the port's own copy of the JAX package's
// native/tokenizer.cpp, built by imagecaptioner_tpu_torch/native/__init__.py.
//
// Contract (must stay token-identical with the Python implementation; the
// fuzz test in tests/test_torch_port_native_tokenizer.py enforces it):
//   * whitespace split
//   * peel prefix punctuation ([({"'`$#@<) and suffix punctuation
//     (.,!?:;"')]}%>) one char at a time
//   * trailing ellipsis runs (2+ dots) peeled as ONE token; dot-runs also
//     split as single infix tokens (spaCy ELLIPSES)
//   * dotted single-LETTER acronyms ("u.k.", "a.") keep their final period
//   * contraction suffixes n't 's 'm 're 've 'll 'd split off (case-insensitive)
//   * whole-word exceptions: cannot gonna gotta wanna lemme gimme split in two
//   * '-'/'/' infixes split into separate tokens when all pieces are wordish
//   * everything lowercased (ASCII; multi-byte UTF-8 passes through)
//
// Exported C ABI (ctypes):
//   int ic_tokenize(const char* text, char* out, int cap)
//     -> writes '\n'-joined tokens into out, returns total bytes written
//        (excluding NUL), or -1 if cap is too small.
//
// Build: g++ -O2 -shared -fPIC -o libtokenizer-<hash>.so tokenizer.cpp

#include <cctype>
#include <cstring>
#include <string>
#include <vector>

namespace {

const char* kPrefix = "([{\"'`$#@<";
const char* kSuffix = ".,!?:;\"')]}%>";
const char* kContractions[] = {"n't", "'s", "'m", "'re", "'ve", "'ll", "'d"};

bool is_prefix_punct(char c) { return std::strchr(kPrefix, c) != nullptr; }
bool is_suffix_punct(char c) { return std::strchr(kSuffix, c) != nullptr; }

std::string lower(const std::string& s) {
  std::string out(s);
  for (auto& c : out)
    c = static_cast<char>(std::tolower(static_cast<unsigned char>(c)));
  return out;
}

bool wordish(const std::string& s) {
  // python \w: alnum or underscore (ASCII approximation)
  for (unsigned char c : s)
    if (std::isalnum(c) || c == '_' || c >= 0x80) return true;
  return false;
}

bool is_dot_run(const std::string& s) {
  if (s.size() < 2) return false;
  for (char c : s)
    if (c != '.') return false;
  return true;
}

// letters only: "u.k." / "a." stay whole (spaCy), "9." still splits
bool is_dotted_acronym(const std::string& s) {
  if (s.size() < 2 || s.size() % 2 != 0) return false;
  for (size_t i = 0; i < s.size(); i += 2) {
    unsigned char c = s[i];
    if (!(std::isalpha(c) || c >= 0x80) || s[i + 1] != '.') return false;
  }
  return true;
}

void split_infix(const std::string& chunk, std::vector<std::string>* out) {
  if (chunk.empty()) return;
  std::vector<std::string> parts;
  std::string cur;
  for (size_t i = 0; i < chunk.size();) {
    char c = chunk[i];
    if (c == '.' && i + 1 < chunk.size() && chunk[i + 1] == '.') {
      // ellipsis run: one separator token (mirrors python \.{2,})
      size_t j = i;
      while (j < chunk.size() && chunk[j] == '.') ++j;
      if (!cur.empty()) parts.push_back(cur);
      parts.push_back(chunk.substr(i, j - i));
      cur.clear();
      i = j;
    } else if (c == '-' || c == '/') {
      if (!cur.empty()) parts.push_back(cur);
      parts.push_back(std::string(1, c));
      cur.clear();
      ++i;
    } else {
      cur.push_back(c);
      ++i;
    }
  }
  if (!cur.empty()) parts.push_back(cur);
  if (parts.size() == 1) {
    out->push_back(chunk);
    return;
  }
  for (const auto& p : parts) {
    if (!(wordish(p) || p == "-" || p == "/" || is_dot_run(p))) {
      out->push_back(chunk);  // keep whole, like the python fallback
      return;
    }
  }
  for (const auto& p : parts) out->push_back(p);
}

void split_chunk(std::string chunk, std::vector<std::string>* out) {
  std::vector<std::string> prefix, suffix;
  while (!chunk.empty() && is_prefix_punct(chunk.front())) {
    prefix.push_back(std::string(1, chunk.front()));
    chunk.erase(chunk.begin());
  }
  while (!chunk.empty() && is_suffix_punct(chunk.back())) {
    if (chunk.back() == '.' && chunk.size() >= 2 &&
        chunk[chunk.size() - 2] == '.') {
      // trailing ellipsis run is ONE token
      size_t j = chunk.size();
      while (j > 0 && chunk[j - 1] == '.') --j;
      suffix.push_back(chunk.substr(j));
      chunk.erase(j);
      continue;
    }
    if (chunk.back() == '.' && is_dotted_acronym(chunk)) {
      break;  // "u.k." keeps its final period
    }
    suffix.push_back(std::string(1, chunk.back()));
    chunk.pop_back();
  }
  for (const auto& p : prefix) out->push_back(p);
  if (!chunk.empty()) {
    std::string lowered = lower(chunk);
    // whole-word exceptions (spaCy en tokenizer_exceptions)
    static const struct { const char* word; size_t split; } kExceptions[] = {
        {"cannot", 3}, {"gonna", 3}, {"gotta", 3},
        {"wanna", 3}, {"lemme", 3}, {"gimme", 3}};
    bool exc_done = false;
    for (const auto& e : kExceptions) {
      if (lowered == e.word) {
        out->push_back(chunk.substr(0, e.split));
        out->push_back(chunk.substr(e.split));
        exc_done = true;
        break;
      }
    }
    const std::string* matched = nullptr;
    static const std::vector<std::string> contractions(
        kContractions, kContractions + 7);
    if (!exc_done) {
      for (const auto& c : contractions) {
        if (lowered.size() > c.size() &&
            lowered.compare(lowered.size() - c.size(), c.size(), c) == 0) {
          matched = &c;
          break;
        }
      }
      if (matched) {
        split_infix(chunk.substr(0, chunk.size() - matched->size()), out);
        out->push_back(chunk.substr(chunk.size() - matched->size()));
      } else {
        split_infix(chunk, out);
      }
    }
  }
  for (auto it = suffix.rbegin(); it != suffix.rend(); ++it)
    out->push_back(*it);
}

}  // namespace

extern "C" int ic_tokenize(const char* text, char* out, int cap) {
  std::vector<std::string> tokens;
  std::string chunk;
  for (const char* p = text;; ++p) {
    char c = *p;
    if (c == '\0' || std::isspace(static_cast<unsigned char>(c))) {
      if (!chunk.empty()) {
        split_chunk(chunk, &tokens);
        chunk.clear();
      }
      if (c == '\0') break;
    } else {
      chunk.push_back(c);
    }
  }
  std::string joined;
  for (size_t i = 0; i < tokens.size(); ++i) {
    if (i) joined.push_back('\n');
    joined += lower(tokens[i]);
  }
  if (static_cast<int>(joined.size()) + 1 > cap) return -1;
  std::memcpy(out, joined.c_str(), joined.size() + 1);
  return static_cast<int>(joined.size());
}
