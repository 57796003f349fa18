// BPE trainer: corpus (one utterance per line) -> LABPE1 model file;
// and the encoder, with BPE-dropout.
//
// Word-frequency BPE: the alphabet is every word's characters, the word
// marker U+2581 fused with each word's first character; each merge joins
// the most frequent adjacent pair (merge count = vocab - alphabet - 4,
// stopping early when no pair occurs twice), and updates the pair counts
// of the words that contain it only. Words, the alphabet and ties between
// pair counts are ordered by std::unordered_map iteration, so the token
// ids are those of this exact algorithm and container; a trainer in
// another language orders them otherwise and gives other ids.
//
// Model file (text):
//   LABPE1\n<vocab_sz>\n<n_merges>\n
//   <token>\n x vocab_sz           (id = line order; 0-3 are
//                                  <PAD> <UNK> <BOS> <EOS>)
//   <left> <right>\n x n_merges    (rank = line order)
//
// The encoder (data/bpe.py's, for every dropout, 0 included): each
// lower-cased word is split into characters, the word marker fused with
// the first (or a symbol of its own in models that hold a bare marker),
// and the lowest-ranked merge is applied until none applies; but each
// candidate merge is skipped with probability `dropout`, by the C
// library's rand_r seeded once a call (seed 0 means 12345). The draws
// are those of the JAX package's native encoder, so with the same seed
// and the same libc the ids are its ids.
//
// Built with g++ at first use (libreasr_tpu_torch/ops/kernels/build.py,
// load_host) and called through ctypes:
//   int bpe_train(const char* corpus, const char* model, int vocab_size)
// returns 0, or -1 (corpus unreadable), -2 (no words), -3 (model
// unwritable);
//   void* bpe_load(const char* model)     a model handle, or NULL
//   void bpe_free_model(void* handle)
//   int bpe_encode_dropout(void* handle, const char* text, int32_t* out,
//                          int max_out, double dropout, unsigned seed)
// writes at most max_out ids and returns how many the text has.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

const char* META = "\xe2\x96\x81";  // U+2581 lower one-eighth block

struct PairHash {
  size_t operator()(const std::pair<int, int>& p) const {
    return std::hash<int64_t>()(((int64_t)p.first << 32) | (uint32_t)p.second);
  }
};

std::vector<std::string> utf8_chars(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    unsigned char c = s[i];
    int len = c < 0x80 ? 1 : (c >> 5) == 6 ? 2 : (c >> 4) == 14 ? 3 : 4;
    out.push_back(s.substr(i, len));
    i += len;
  }
  return out;
}

std::string lower_ascii(const std::string& s) {
  std::string o = s;
  for (auto& c : o)
    if (c >= 'A' && c <= 'Z') c += 32;
  return o;
}

struct Model {
  std::vector<std::string> vocab;                   // id -> token
  std::unordered_map<std::string, int> token_to_id;
  std::unordered_map<std::string, int> merge_rank;  // "left right" -> rank
  bool meta_standalone = false;  // the marker is a token of its own

  int id_of(const std::string& t) const {
    auto it = token_to_id.find(t);
    return it == token_to_id.end() ? 1 /*UNK*/ : it->second;
  }
};

void encode_word(const Model& m, const std::string& word,
                 std::vector<int>& out, double dropout, unsigned* rng) {
  std::vector<std::string> syms = utf8_chars(word);
  if (syms.empty()) return;
  if (m.meta_standalone)
    syms.insert(syms.begin(), META);
  else
    syms[0] = META + syms[0];
  while (syms.size() > 1) {
    int best_rank = INT32_MAX, best_i = -1;
    for (size_t i = 0; i + 1 < syms.size(); i++) {
      auto it = m.merge_rank.find(syms[i] + " " + syms[i + 1]);
      if (it != m.merge_rank.end() && it->second < best_rank) {
        if (dropout > 0.0 && (double)rand_r(rng) / RAND_MAX < dropout)
          continue;
        best_rank = it->second;
        best_i = (int)i;
      }
    }
    if (best_i < 0) break;
    syms[best_i] = syms[best_i] + syms[best_i + 1];
    syms.erase(syms.begin() + best_i + 1);
  }
  for (auto& s : syms) out.push_back(m.id_of(s));
}

}  // namespace

extern "C" {

int bpe_train(const char* corpus_path, const char* model_path,
              int vocab_size) {
  std::ifstream in(corpus_path);
  if (!in) return -1;

  // 1. word frequencies
  std::unordered_map<std::string, int64_t> wfreq;
  std::string line, w;
  while (std::getline(in, line)) {
    std::istringstream ss(lower_ascii(line));
    while (ss >> w) wfreq[w]++;
  }
  if (wfreq.empty()) return -2;

  // 2. words as symbol-id sequences; alphabet
  std::vector<std::string> sym_str;  // sym id -> string
  std::unordered_map<std::string, int> sym_id;
  auto get_sym = [&](const std::string& s) {
    auto it = sym_id.find(s);
    if (it != sym_id.end()) return it->second;
    int id = (int)sym_str.size();
    sym_str.push_back(s);
    sym_id[s] = id;
    return id;
  };

  struct Word {
    std::vector<int> syms;
    int64_t count;
  };
  std::vector<Word> words;
  words.reserve(wfreq.size());
  for (auto& [text, count] : wfreq) {
    Word word;
    word.count = count;
    auto chars = utf8_chars(text);
    if (chars.empty()) continue;
    chars[0] = META + chars[0];
    for (auto& c : chars) word.syms.push_back(get_sym(c));
    words.push_back(std::move(word));
  }

  // 3. pair counts + occurrence sets
  using Pair = std::pair<int, int>;
  std::unordered_map<Pair, int64_t, PairHash> pcount;
  std::unordered_map<Pair, std::unordered_set<int>, PairHash> pwords;
  for (int wi = 0; wi < (int)words.size(); wi++) {
    auto& ws = words[wi].syms;
    for (size_t i = 0; i + 1 < ws.size(); i++) {
      Pair p{ws[i], ws[i + 1]};
      pcount[p] += words[wi].count;
      pwords[p].insert(wi);
    }
  }

  int n_special = 4;
  int target_merges = vocab_size - n_special - (int)sym_str.size();
  std::vector<Pair> merges;

  // 4. iterative merging with incremental updates
  for (int step = 0; step < target_merges; step++) {
    Pair best{-1, -1};
    int64_t best_count = 0;
    for (auto& [p, c] : pcount) {
      if (c > best_count) {
        best_count = c;
        best = p;
      }
    }
    if (best_count < 2) break;
    int new_sym = get_sym(sym_str[best.first] + sym_str[best.second]);
    merges.push_back(best);

    auto affected = pwords[best];  // copy — we mutate pwords below
    for (int wi : affected) {
      auto& ws = words[wi].syms;
      int64_t cnt = words[wi].count;
      // remove old pair contributions of this word
      for (size_t i = 0; i + 1 < ws.size(); i++) {
        Pair p{ws[i], ws[i + 1]};
        pcount[p] -= cnt;
        if (pcount[p] <= 0) pcount.erase(p);
      }
      // apply the merge inside the word
      std::vector<int> ns;
      ns.reserve(ws.size());
      for (size_t i = 0; i < ws.size();) {
        if (i + 1 < ws.size() && ws[i] == best.first && ws[i + 1] == best.second) {
          ns.push_back(new_sym);
          i += 2;
        } else {
          ns.push_back(ws[i]);
          i += 1;
        }
      }
      ws = std::move(ns);
      // add new pair contributions
      for (size_t i = 0; i + 1 < ws.size(); i++) {
        Pair p{ws[i], ws[i + 1]};
        pcount[p] += cnt;
        pwords[p].insert(wi);
      }
    }
    pcount.erase(best);
    pwords.erase(best);
  }

  // 5. write model: specials + alphabet + merged symbols (ids in order)
  std::ofstream outf(model_path);
  if (!outf) return -3;
  outf << "LABPE1\n" << (n_special + sym_str.size()) << "\n" << merges.size() << "\n";
  outf << "<PAD>\n<UNK>\n<BOS>\n<EOS>\n";
  for (auto& s : sym_str) outf << s << "\n";
  for (auto& m : merges)
    outf << sym_str[m.first] << " " << sym_str[m.second] << "\n";
  return 0;
}

void* bpe_load(const char* model_path) {
  std::ifstream in(model_path);
  if (!in) return nullptr;
  std::string magic;
  size_t vocab_sz, n_merges;
  in >> magic >> vocab_sz >> n_merges;
  if (magic != "LABPE1") return nullptr;
  std::string line;
  std::getline(in, line);
  Model* m = new Model();
  m->vocab.reserve(vocab_sz);
  for (size_t i = 0; i < vocab_sz; i++) {
    std::getline(in, line);
    m->vocab.push_back(line);
    m->token_to_id[line] = (int)i;
  }
  for (size_t r = 0; r < n_merges; r++) {
    std::getline(in, line);
    m->merge_rank[line] = (int)r;
  }
  m->meta_standalone = m->token_to_id.count(META) > 0;
  return m;
}

void bpe_free_model(void* handle) { delete (Model*)handle; }

int bpe_encode_dropout(void* handle, const char* text, int32_t* out,
                       int max_out, double dropout, unsigned seed) {
  Model* m = (Model*)handle;
  std::istringstream ss(lower_ascii(text));
  std::string w;
  std::vector<int> ids;
  unsigned rng = seed ? seed : 12345u;
  while (ss >> w) encode_word(*m, w, ids, dropout, &rng);
  int n = std::min((int)ids.size(), max_out);
  for (int i = 0; i < n; i++) out[i] = ids[i];
  return (int)ids.size();
}

}  // extern "C"
