// BPE trainer: corpus (one utterance per line) -> LABPE1 model file.
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
// Built with g++ at first use (libreasr_tpu_torch/ops/kernels/build.py,
// load_host) and called through ctypes:
//   int bpe_train(const char* corpus, const char* model, int vocab_size)
// returns 0, or -1 (corpus unreadable), -2 (no words), -3 (model
// unwritable).

#include <cstdint>
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

}  // extern "C"
