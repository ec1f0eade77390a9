// Native BERT WordPiece tokenizer (greedy longest-match-first).
//
// The reference tokenizes with HF's Rust BertTokenizerFast (its
// src/tasks/run_video_retrieval.py:334). This is the port's own native
// host-path implementation (the JAX package's tokenizer.cpp, the same code),
// matching alpro_tpu_torch/data/tokenization.py::WordPieceTokenizer for
// ASCII text.
//
// SCOPE: byte-level, ASCII-exact. Non-ASCII input (UTF-8 multibyte) is kept
// as opaque word bytes — unicode punctuation is not split and non-ASCII
// letters are not lowercased, so ids can differ from the python tokenizer
// there (proper unicode segmentation needs ICU-class tables). The python /
// HF tokenizers are the primary path; this one serves ASCII-heavy serving
// hosts that must not carry a python text stack.
//
// C ABI:
//   alpro_tok_create(vocab_path, lowercase) -> handle
//   alpro_tok_encode(handle, text, max_len, out_ids) -> n_tokens (CLS..SEP,
//       truncated to max_len, caller buffer of max_len int32)
//   alpro_tok_destroy(handle)

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  bool lowercase = true;
  int32_t pad_id = 0, unk_id = 0, cls_id = 0, sep_id = 0, mask_id = 0;
  size_t max_chars_per_word = 100;

  bool load(const char* path) {
    std::ifstream f(path);
    if (!f.is_open()) return false;
    std::string line;
    int32_t idx = 0;
    while (std::getline(f, line)) {
      if (!line.empty() && line.back() == '\r') line.pop_back();
      vocab.emplace(line, idx++);
    }
    auto get = [&](const char* tok, int32_t* out) {
      auto it = vocab.find(tok);
      if (it == vocab.end()) return false;
      *out = it->second;
      return true;
    };
    return get("[PAD]", &pad_id) && get("[UNK]", &unk_id) &&
           get("[CLS]", &cls_id) && get("[SEP]", &sep_id) &&
           get("[MASK]", &mask_id);
  }

  // basic tokenization: split on whitespace; punctuation is its own token
  // (matches the python WordPieceTokenizer's _basic_tokenize: alnum + ')
  void basic_tokens(const std::string& text, std::vector<std::string>* out) const {
    std::string word;
    for (unsigned char ch : text) {
      char c = lowercase ? (char)std::tolower(ch) : (char)ch;
      if (std::isalnum((unsigned char)c) || c == '\'' || (unsigned char)c >= 0x80) {
        word.push_back(c);
      } else {
        if (!word.empty()) {
          out->push_back(word);
          word.clear();
        }
        if (!std::isspace((unsigned char)c)) out->push_back(std::string(1, c));
      }
    }
    if (!word.empty()) out->push_back(word);
  }

  void wordpiece(const std::string& word, std::vector<int32_t>* ids) const {
    if (word.size() > max_chars_per_word) {
      ids->push_back(unk_id);
      return;
    }
    std::vector<int32_t> pieces;
    size_t start = 0;
    while (start < word.size()) {
      size_t end = word.size();
      int32_t cur = -1;
      while (start < end) {
        std::string sub = word.substr(start, end - start);
        if (start > 0) sub = "##" + sub;
        auto it = vocab.find(sub);
        if (it != vocab.end()) {
          cur = it->second;
          break;
        }
        --end;
      }
      if (cur < 0) {
        ids->push_back(unk_id);
        return;
      }
      pieces.push_back(cur);
      start = end;
    }
    ids->insert(ids->end(), pieces.begin(), pieces.end());
  }

  int encode(const char* text, int max_len, int32_t* out) const {
    std::vector<std::string> words;
    basic_tokens(text, &words);
    std::vector<int32_t> ids;
    ids.push_back(cls_id);
    for (const auto& w : words) {
      wordpiece(w, &ids);
      if ((int)ids.size() >= max_len - 1) break;
    }
    if ((int)ids.size() > max_len - 1) ids.resize(max_len - 1);
    ids.push_back(sep_id);
    for (int i = 0; i < max_len; ++i)
      out[i] = (i < (int)ids.size()) ? ids[i] : pad_id;
    return (int)ids.size();
  }
};

}  // namespace

extern "C" {

void* alpro_tok_create(const char* vocab_path, int lowercase) {
  auto* t = new Tokenizer();
  t->lowercase = lowercase != 0;
  if (!t->load(vocab_path)) {
    delete t;
    return nullptr;
  }
  return t;
}

int alpro_tok_encode(void* handle, const char* text, int max_len,
                     int32_t* out) {
  if (!handle) return -1;
  return static_cast<Tokenizer*>(handle)->encode(text, max_len, out);
}

void alpro_tok_destroy(void* handle) {
  delete static_cast<Tokenizer*>(handle);
}

}  // extern "C"
