// Native incremental NFA table: bulk build + O(delta) mutation at
// 10M-filter scale, byte-compatible with the Python tables' layout
// (emqx_tpu_torch/ops/compiler.py, ops/incremental.py): node_tab (S,4)
// int32 rows [plus_child, hash_accept, accept, 0] and a 2-choice
// cuckoo edge_tab (Hb, BUCKET_SLOTS*4) int32 of [state, word, next, 0]
// slots, with the SAME uint32 bucket-hash mixing, so the walk kernels
// consume either producer's arrays unchanged.
//
// The port's copy of the reference's emqx_tpu/native/nfa.cpp, with the
// same code plus one read-only entry (nfa_bulk_aid_of): from the same
// calls on the same compiler, both produce the same bytes (cuckoo seeds
// come from std::mt19937).  The Python
// IncrementalNfa is the semantics oracle; this is the scale path — a
// Python object trie at 20M nodes costs GBs and minutes.
//
// C ABI only, bound with ctypes (emqx_tpu_torch/native/nfa.py).  All
// buffers are caller-allocated numpy arrays sized via nfa_sizes /
// nfa_delta_sizes.  Built by emqx_tpu_torch/native/build.py.

#include <cstdint>
#include <cstring>
#include <deque>
#include <random>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int BUCKET_SLOTS = 2;   // = ops/compiler.py BUCKET_SLOTS
constexpr int ROW = BUCKET_SLOTS * 4;   // int32s per bucket row
constexpr int MAX_KICKS = 500;

inline uint32_t bucket_hash(uint32_t state, uint32_t word, uint32_t seed,
                            uint32_t mask) {
  uint32_t h = state * 2654435761u + word * 2246822519u + seed;
  h ^= h >> 16;
  h *= 3266489917u;
  h ^= h >> 13;
  return h & mask;
}

inline uint64_t ckey(int32_t sid, int32_t wid) {
  return (uint64_t(uint32_t(sid)) << 32) | uint32_t(wid);
}

struct Node {
  int32_t plus = -1;       // '+' child sid
  int32_t hash_aid = -1;   // '#' accept id
  int32_t aid = -1;        // end accept id
  int32_t parent = -1;
  int32_t pword = -1;      // vocab id of parent edge; -2 = '+' edge; -1 root
  uint32_t nlit = 0;       // count of literal children
  bool live = false;
};

struct Nfa {
  int32_t depth;
  uint64_t epoch = 0;
  // -2 = no device consumer (freed aids reusable immediately);
  // -1 = consumer attached, nothing acked yet (no reuse);
  // >=0 = highest epoch the device has applied
  int64_t device_epoch = -2;
  uint64_t aid_reuses = 0;
  int32_t n_states = 1;
  int64_t n_edges = 0;
  int64_t n_filters = 0;

  std::vector<Node> nodes;           // sid-indexed
  std::vector<int32_t> free_sids;
  std::unordered_map<uint64_t, int32_t> children;  // (sid,wid) -> child

  // heterogeneous lookup: find(string_view) without a temp std::string —
  // the build path does tens of millions of interning probes
  struct SvHash {
    using is_transparent = void;
    size_t operator()(std::string_view s) const noexcept {
      return std::hash<std::string_view>{}(s);
    }
  };
  struct SvEq {
    using is_transparent = void;
    bool operator()(std::string_view a, std::string_view b) const noexcept {
      return a == b;
    }
  };
  std::unordered_map<std::string, int32_t, SvHash, SvEq> vocab;
  std::vector<std::string> vocab_list;             // id-1 -> word

  std::vector<std::string> accepts;  // aid -> filter ("" = hole)
  std::vector<uint8_t> accept_live;
  std::deque<std::pair<uint64_t, int32_t>> free_aids;  // (freed_epoch, aid)
  // alias aids: ids in the same accept space with NO trie states —
  // filters deeper than the table that still need one id→filter map
  // (mirrors IncrementalNfa.alloc_alias/free_alias)
  std::unordered_set<int32_t> alias_aids;

  std::vector<int32_t> edge_tab;  // Hb * ROW
  uint32_t Hb;
  uint32_t seeds[2];
  std::mt19937 rng;

  std::unordered_set<int32_t> dirty_states;
  std::unordered_set<int32_t> dirty_buckets;
  bool resized = false;

  Nfa(int32_t depth_, uint32_t state_bucket, uint32_t edge_bucket,
      uint64_t seed)
      : depth(depth_), rng(seed) {
    nodes.resize(state_bucket);
    nodes[0].live = true;
    for (int32_t i = int32_t(state_bucket) - 1; i >= 1; --i)
      free_sids.push_back(i);
    Hb = 8;
    while (Hb < edge_bucket) Hb <<= 1;
    edge_tab.assign(size_t(Hb) * ROW, -1);
    reseed();
    dirty_states.insert(0);
  }

  void reseed() {
    std::uniform_int_distribution<uint32_t> d(1, 0x7fffffffu);
    seeds[0] = d(rng);
    seeds[1] = d(rng);
  }

  uint32_t S() const { return uint32_t(nodes.size()); }

  int32_t alloc_sid() {
    if (free_sids.empty()) {
      size_t old = nodes.size();
      nodes.resize(old * 2);
      for (int32_t i = int32_t(old * 2) - 1; i >= int32_t(old); --i)
        free_sids.push_back(i);
      resized = true;
    }
    int32_t sid = free_sids.back();
    free_sids.pop_back();
    nodes[sid] = Node{};
    nodes[sid].live = true;
    return sid;
  }

  int32_t alloc_aid(std::string_view flt) {
    if (!free_aids.empty()) {
      auto [fe, aid] = free_aids.front();
      if (device_epoch == -2 ||
          (device_epoch >= 0 && fe <= uint64_t(device_epoch))) {
        free_aids.pop_front();
        accepts[aid].assign(flt);
        accept_live[aid] = 1;
        ++aid_reuses;
        return aid;
      }
    }
    accepts.emplace_back(flt);
    accept_live.push_back(1);
    return int32_t(accepts.size()) - 1;
  }

  void free_aid(int32_t aid) {
    accepts[aid].clear();
    accept_live[aid] = 0;
    free_aids.emplace_back(epoch + 1, aid);
  }

  int32_t intern(std::string_view w) {
#if defined(__cpp_lib_generic_unordered_lookup)
    auto it = vocab.find(w);
#else
    // libstdc++ < 11 lacks heterogeneous unordered lookup: pay the temp
    auto it = vocab.find(std::string(w));
#endif
    if (it != vocab.end()) return it->second;
    int32_t id = int32_t(vocab.size()) + 1;  // 0 reserved UNKNOWN
    vocab.emplace(std::string(w), id);
    vocab_list.emplace_back(w);
    return id;
  }

  int32_t vocab_get(std::string_view w) const {
#if defined(__cpp_lib_generic_unordered_lookup)
    auto it = vocab.find(w);
#else
    auto it = vocab.find(std::string(w));
#endif
    return it == vocab.end() ? 0 : it->second;
  }

  // -- cuckoo edges --------------------------------------------------------

  bool place(std::vector<int32_t>& tab, uint32_t hb, const uint32_t sd[2],
             int32_t s, int32_t w, int32_t nxt,
             std::unordered_set<int32_t>* dirty) {
    int32_t cs = s, cw = w, cn = nxt;
    uint32_t mask = hb - 1;
    std::uniform_int_distribution<int> coin(0, 1), slot(0, BUCKET_SLOTS - 1);
    for (int k = 0; k < MAX_KICKS; ++k) {
      uint32_t b[2] = {bucket_hash(cs, cw, sd[0], mask),
                       bucket_hash(cs, cw, sd[1], mask)};
      for (int j = 0; j < 2; ++j) {
        int32_t* row = &tab[size_t(b[j]) * ROW];
        for (int i = 0; i < BUCKET_SLOTS; ++i) {
          if (row[i * 4] < 0) {
            row[i * 4] = cs;
            row[i * 4 + 1] = cw;
            row[i * 4 + 2] = cn;
            if (dirty) dirty->insert(int32_t(b[j]));
            return true;
          }
        }
      }
      uint32_t vb = b[coin(rng)];
      int vi = slot(rng) * 4;
      int32_t* row = &tab[size_t(vb) * ROW];
      int32_t vs = row[vi], vw = row[vi + 1], vn = row[vi + 2];
      row[vi] = cs;
      row[vi + 1] = cw;
      row[vi + 2] = cn;
      if (dirty) dirty->insert(int32_t(vb));
      cs = vs;
      cw = vw;
      cn = vn;
    }
    // homeless victim: put it back conceptually by failing the caller
    // (caller grows and re-places everything including (cs,cw,cn))
    pending[0] = cs;
    pending[1] = cw;
    pending[2] = cn;
    has_pending = true;
    return false;
  }

  int32_t pending[3] = {-1, -1, -1};
  bool has_pending = false;

  void edge_insert(int32_t s, int32_t wid, int32_t nxt) {
    if (n_edges >= int64_t(Hb) * BUCKET_SLOTS * 3 / 4) grow(false);
    if (!place(edge_tab, Hb, seeds, s, wid, nxt, &dirty_buckets)) {
      // failed walk left the new edge placed and ONE homeless victim in
      // `pending`; grow() re-places every live edge plus the victim
      grow(true);
    }
    ++n_edges;
  }

  void grow(bool with_pending) {
    std::vector<std::pair<uint64_t, int32_t>> live;
    live.reserve(size_t(n_edges) + 1);
    for (size_t b = 0; b < Hb; ++b) {
      const int32_t* row = &edge_tab[b * ROW];
      for (int i = 0; i < BUCKET_SLOTS; ++i)
        if (row[i * 4] >= 0)
          live.emplace_back(ckey(row[i * 4], row[i * 4 + 1]), row[i * 4 + 2]);
    }
    if (with_pending && has_pending) {
      live.emplace_back(ckey(pending[0], pending[1]), pending[2]);
      has_pending = false;
    }
    uint32_t hb = Hb;
    for (;;) {
      hb <<= 1;
      for (int attempt = 0; attempt < 4; ++attempt) {
        uint32_t sd[2];
        std::uniform_int_distribution<uint32_t> d(1, 0x7fffffffu);
        sd[0] = d(rng);
        sd[1] = d(rng);
        std::vector<int32_t> tab(size_t(hb) * ROW, -1);
        bool ok = true;
        for (auto& [key, nxt] : live) {
          int32_t s = int32_t(key >> 32), w = int32_t(key & 0xffffffff);
          if (!place(tab, hb, sd, s, w, nxt, nullptr)) {
            has_pending = false;
            ok = false;
            break;
          }
        }
        if (ok) {
          edge_tab.swap(tab);
          Hb = hb;
          seeds[0] = sd[0];
          seeds[1] = sd[1];
          resized = true;
          dirty_buckets.clear();
          return;
        }
      }
    }
  }

  void edge_delete(int32_t s, int32_t wid) {
    uint32_t mask = Hb - 1;
    for (int j = 0; j < 2; ++j) {
      uint32_t b = bucket_hash(s, wid, seeds[j], mask);
      int32_t* row = &edge_tab[size_t(b) * ROW];
      for (int i = 0; i < BUCKET_SLOTS; ++i) {
        if (row[i * 4] == s && row[i * 4 + 1] == wid) {
          row[i * 4] = row[i * 4 + 1] = row[i * 4 + 2] = -1;
          dirty_buckets.insert(int32_t(b));
          --n_edges;
          return;
        }
      }
    }
  }

  // -- filter mutation -----------------------------------------------------

  // split a filter/topic into words; returns false if > depth levels
  static bool split(std::string_view s, std::vector<std::string_view>& out) {
    out.clear();
    size_t start = 0;
    for (size_t i = 0; i <= s.size(); ++i) {
      if (i == s.size() || s[i] == '/') {
        out.push_back(s.substr(start, i - start));
        start = i + 1;
      }
    }
    return true;
  }

  // returns 1 added, 0 duplicate, -1 invalid (too deep, or '#' not in
  // final position — a mid-filter '#' would otherwise truncate-insert a
  // DIFFERENT filter that remove()/aid_of() can never find again)
  int add(std::string_view flt) {
    std::vector<std::string_view> ws;
    split(flt, ws);
    if (int32_t(ws.size()) > depth) return -1;
    for (size_t i = 0; i + 1 < ws.size(); ++i)
      if (ws[i] == "#") return -1;
    int32_t sid = 0;
    for (size_t i = 0; i < ws.size(); ++i) {
      std::string_view w = ws[i];
      if (w == "#") {
        Node& n = nodes[sid];
        if (n.hash_aid >= 0) return 0;
        n.hash_aid = alloc_aid(flt);
        dirty_states.insert(sid);
        ++n_filters;
        ++epoch;
        return 1;
      }
      if (w == "+") {
        if (nodes[sid].plus < 0) {
          int32_t child = alloc_sid();
          nodes[child].parent = sid;
          nodes[child].pword = -2;
          nodes[sid].plus = child;
          dirty_states.insert(sid);
          dirty_states.insert(child);
          ++n_states;
        }
        sid = nodes[sid].plus;
      } else {
        int32_t wid = intern(w);
        auto it = children.find(ckey(sid, wid));
        if (it == children.end()) {
          int32_t child = alloc_sid();
          nodes[child].parent = sid;
          nodes[child].pword = wid;
          children.emplace(ckey(sid, wid), child);
          ++nodes[sid].nlit;
          dirty_states.insert(child);
          edge_insert(sid, wid, child);
          ++n_states;
          sid = child;
        } else {
          sid = it->second;
        }
      }
    }
    Node& n = nodes[sid];
    if (n.aid >= 0) return 0;
    n.aid = alloc_aid(flt);
    dirty_states.insert(sid);
    ++n_filters;
    ++epoch;
    return 1;
  }

  int remove(std::string_view flt) {
    std::vector<std::string_view> ws;
    split(flt, ws);
    if (int32_t(ws.size()) > depth) return 0;
    bool ends_hash = !ws.empty() && ws.back() == "#";
    size_t walk_n = ends_hash ? ws.size() - 1 : ws.size();
    int32_t sid = 0;
    for (size_t i = 0; i < walk_n; ++i) {
      std::string_view w = ws[i];
      if (w == "+") {
        sid = nodes[sid].plus;
      } else {
        int32_t wid = vocab_get(w);
        if (wid == 0) return 0;
        auto it = children.find(ckey(sid, wid));
        sid = (it == children.end()) ? -1 : it->second;
      }
      if (sid < 0) return 0;
    }
    Node& n = nodes[sid];
    if (ends_hash) {
      if (n.hash_aid < 0) return 0;
      free_aid(n.hash_aid);
      n.hash_aid = -1;
    } else {
      if (n.aid < 0) return 0;
      free_aid(n.aid);
      n.aid = -1;
    }
    dirty_states.insert(sid);
    prune(sid);
    --n_filters;
    ++epoch;
    return 1;
  }

  void prune(int32_t sid) {
    while (sid != 0) {
      Node& n = nodes[sid];
      if (n.nlit != 0 || n.plus >= 0 || n.hash_aid >= 0 || n.aid >= 0) return;
      int32_t parent = n.parent;
      if (n.pword == -2) {
        nodes[parent].plus = -1;
      } else {
        children.erase(ckey(parent, n.pword));
        --nodes[parent].nlit;
        edge_delete(parent, n.pword);
      }
      n = Node{};  // clears live
      dirty_states.insert(sid);
      dirty_states.insert(parent);
      free_sids.push_back(sid);
      --n_states;
      sid = parent;
    }
  }

  int32_t aid_of(std::string_view flt) const {
    std::vector<std::string_view> ws;
    split(flt, ws);
    if (int32_t(ws.size()) > depth) return -1;
    bool ends_hash = !ws.empty() && ws.back() == "#";
    size_t walk_n = ends_hash ? ws.size() - 1 : ws.size();
    int32_t sid = 0;
    for (size_t i = 0; i < walk_n; ++i) {
      std::string_view w = ws[i];
      if (w == "+") {
        sid = nodes[sid].plus;
      } else {
        int32_t wid = vocab_get(w);
        if (wid == 0) return -1;
        auto it = children.find(ckey(sid, wid));
        sid = (it == children.end()) ? -1 : it->second;
      }
      if (sid < 0) return -1;
    }
    return ends_hash ? nodes[sid].hash_aid : nodes[sid].aid;
  }

  // host-side authoritative match (fail-open path); same semantics as
  // IncrementalNfa.match_host: '+' one level, '#' >= 0 trailing levels,
  // root wildcards suppressed for '$'-topics
  int match_topic(std::string_view topic, int32_t* out, int cap) const {
    std::vector<std::string_view> ws;
    split(topic, ws);
    bool is_sys = !topic.empty() && topic[0] == '$';
    int cnt = 0;
    auto emit = [&](int32_t aid) {
      if (cnt < cap) out[cnt] = aid;
      ++cnt;
    };
    std::vector<int32_t> frontier{0}, next;
    for (size_t t = 0; t < ws.size(); ++t) {
      next.clear();
      int32_t wid = vocab_get(ws[t]);
      for (int32_t sid : frontier) {
        const Node& n = nodes[sid];
        if (n.hash_aid >= 0 && !(t == 0 && is_sys)) emit(n.hash_aid);
        if (wid != 0) {
          auto it = children.find(ckey(sid, wid));
          if (it != children.end()) next.push_back(it->second);
        }
        if (n.plus >= 0 && !(t == 0 && is_sys)) next.push_back(n.plus);
      }
      frontier.swap(next);
      if (frontier.empty()) return cnt;
    }
    for (int32_t sid : frontier) {
      const Node& n = nodes[sid];
      if (n.hash_aid >= 0) emit(n.hash_aid);
      if (n.aid >= 0) emit(n.aid);
    }
    return cnt;
  }

  void fill_node_tab(int32_t* node_tab) const {
    // caller allocates (S_pow2, 4); S_pow2 from nfa_sizes
    size_t s_pow2 = node_pow2();
    for (size_t i = 0; i < s_pow2; ++i) {
      int32_t* row = node_tab + i * 4;
      if (i < nodes.size() && nodes[i].live) {
        row[0] = nodes[i].plus;
        row[1] = nodes[i].hash_aid;
        row[2] = nodes[i].aid;
        row[3] = 0;
      } else {
        row[0] = row[1] = row[2] = -1;
        row[3] = 0;
      }
    }
  }

  size_t node_pow2() const {
    size_t s = 1024;
    while (s < nodes.size()) s <<= 1;
    return s;
  }
};

}  // namespace

extern "C" {

void* nfa_new(int32_t depth, int32_t state_bucket, int32_t edge_bucket,
              uint64_t seed) {
  return new Nfa(depth, uint32_t(state_bucket), uint32_t(edge_bucket), seed);
}

void nfa_free(void* h) { delete static_cast<Nfa*>(h); }

int32_t nfa_add(void* h, const char* s, int32_t n) {
  return static_cast<Nfa*>(h)->add(std::string_view(s, size_t(n)));
}

int32_t nfa_remove(void* h, const char* s, int32_t n) {
  return static_cast<Nfa*>(h)->remove(std::string_view(s, size_t(n)));
}

// newline-separated filters; returns count of newly-added filters
int64_t nfa_bulk_add(void* h, const char* buf, int64_t len) {
  Nfa* nfa = static_cast<Nfa*>(h);
  // pre-size the hot hash maps: filters average ~2 trie edges each, and
  // reserving 2x headroom up front (a) kills rehash stalls inside the
  // bulk loop and (b) keeps the FIRST post-bulk incremental adds from
  // paying a multi-hundred-ms one-off rehash of a multi-million-entry
  // map (measured 200 ms at 2M filters), which would blow the <50 ms
  // delta-latency bound on whichever unlucky subscribe lands on it
  int64_t approx = 0;
  for (int64_t i = 0; i < len; ++i) approx += buf[i] == '\n';
  nfa->children.reserve(nfa->children.size() + size_t(approx) * 4);
  nfa->vocab.reserve(nfa->vocab.size() + size_t(approx));
  int64_t added = 0;
  int64_t start = 0;
  for (int64_t i = 0; i <= len; ++i) {
    if (i == len || buf[i] == '\n') {
      if (i > start)
        added += nfa->add(std::string_view(buf + start, size_t(i - start))) > 0;
      start = i + 1;
    }
  }
  return added;
}

// intern one word WITHOUT adding any filter; returns its vocab id.
// Ids assign append-only (vocab.size()+1), so replaying the same word
// sequence into several tables keeps their vocabs identical — the
// multichip shard subtables share one encode vocab this way.
int32_t nfa_intern(void* h, const char* s, int32_t n) {
  return static_cast<Nfa*>(h)->intern(std::string_view(s, size_t(n)));
}

// NUL-separated words (topic words may legally contain '\n', never
// NUL); interns each in order, returns the count consumed
int64_t nfa_bulk_intern(void* h, const char* buf, int64_t len) {
  Nfa* nfa = static_cast<Nfa*>(h);
  int64_t approx = 0;
  for (int64_t i = 0; i < len; ++i) approx += buf[i] == '\0';
  nfa->vocab.reserve(nfa->vocab.size() + size_t(approx) + 1);
  int64_t count = 0;
  int64_t start = 0;
  for (int64_t i = 0; i <= len; ++i) {
    if (i == len || buf[i] == '\0') {
      if (i > start) {
        nfa->intern(std::string_view(buf + start, size_t(i - start)));
        ++count;
      }
      start = i + 1;
    }
  }
  return count;
}

// grow the cuckoo edge table until Hb >= hb_target (pow2 doublings,
// full rehash each step — the multichip restack needs every shard on
// one COMMON Hb, because lookups probe modulo the table size)
int64_t nfa_grow_edges_to(void* h, int64_t hb_target) {
  Nfa* nfa = static_cast<Nfa*>(h);
  while (int64_t(nfa->Hb) < hb_target) nfa->grow(false);
  return int64_t(nfa->Hb);
}

int32_t nfa_aid_of(void* h, const char* s, int32_t n) {
  return static_cast<Nfa*>(h)->aid_of(std::string_view(s, size_t(n)));
}

// newline-separated filters (the nfa_bulk_add framing): out[i] is
// nfa_aid_of of line i (-1 when absent); out holds one int32 per line.
// Returns the line count.  Not in the reference's copy of this file: it
// reads the table only, so every other function's output is unchanged.
int64_t nfa_bulk_aid_of(void* h, const char* buf, int64_t len,
                        int32_t* out) {
  const Nfa* nfa = static_cast<const Nfa*>(h);
  int64_t k = 0;
  int64_t start = 0;
  for (int64_t i = 0; i <= len; ++i) {
    if (i == len || buf[i] == '\n') {
      out[k++] = nfa->aid_of(std::string_view(buf + start, size_t(i - start)));
      start = i + 1;
    }
  }
  return k;
}

int32_t nfa_alloc_alias(void* h, const char* s, int32_t n) {
  Nfa* nfa = static_cast<Nfa*>(h);
  int32_t aid = nfa->alloc_aid(std::string_view(s, size_t(n)));
  nfa->alias_aids.insert(aid);
  ++nfa->epoch;
  return aid;
}

int32_t nfa_free_alias(void* h, int32_t aid) {
  Nfa* nfa = static_cast<Nfa*>(h);
  if (!nfa->alias_aids.erase(aid)) return 0;
  nfa->free_aid(aid);
  ++nfa->epoch;
  return 1;
}

int32_t nfa_match_topic(void* h, const char* s, int32_t n, int32_t* out,
                        int32_t cap) {
  return static_cast<Nfa*>(h)->match_topic(std::string_view(s, size_t(n)),
                                           out, cap);
}

// out[0]=S_pow2 out[1]=Hb out[2]=n_states out[3]=n_edges out[4]=n_accepts
// out[5]=n_filters out[6]=vocab_count out[7]=vocab_bytes out[8]=epoch
// out[9]=resized out[10]=aid_reuses
void nfa_sizes(void* h, int64_t* out) {
  Nfa* n = static_cast<Nfa*>(h);
  out[0] = int64_t(n->node_pow2());
  out[1] = n->Hb;
  out[2] = n->n_states;
  out[3] = n->n_edges;
  out[4] = int64_t(n->accepts.size());
  out[5] = n->n_filters;
  out[6] = int64_t(n->vocab.size());
  int64_t vb = 0;
  for (auto& w : n->vocab_list) vb += int64_t(w.size()) + 1;
  out[7] = vb;
  out[8] = int64_t(n->epoch);
  out[9] = n->resized ? 1 : 0;
  out[10] = int64_t(n->aid_reuses);
}

void nfa_fill_tables(void* h, int32_t* node_tab, int32_t* edge_tab,
                     int32_t* seeds) {
  Nfa* n = static_cast<Nfa*>(h);
  n->fill_node_tab(node_tab);
  std::memcpy(edge_tab, n->edge_tab.data(),
              n->edge_tab.size() * sizeof(int32_t));
  seeds[0] = int32_t(n->seeds[0]);
  seeds[1] = int32_t(n->seeds[1]);
}

// vocab words NUL-joined in id order (id 1 first); buf sized vocab_bytes.
// NUL is the one byte MQTT forbids in topic names (MQTT-1.5.4-2), so it
// cannot appear inside a word; '\n' CAN, which is why it is not used.
void nfa_vocab_fill(void* h, char* buf) {
  Nfa* n = static_cast<Nfa*>(h);
  char* p = buf;
  for (auto& w : n->vocab_list) {
    std::memcpy(p, w.data(), w.size());
    p += w.size();
    *p++ = '\0';
  }
}

int32_t nfa_accept_get(void* h, int32_t aid, char* buf, int32_t cap) {
  Nfa* n = static_cast<Nfa*>(h);
  if (aid < 0 || size_t(aid) >= n->accepts.size() || !n->accept_live[aid])
    return -1;
  const std::string& s = n->accepts[aid];
  if (int32_t(s.size()) > cap) return -1;
  std::memcpy(buf, s.data(), s.size());
  return int32_t(s.size());
}

void nfa_set_device_epoch(void* h, int64_t e) {
  static_cast<Nfa*>(h)->device_epoch = e;
}

// force the next delta to present as a full re-upload (used after a
// bulk load whose delta was deliberately drained host-side)
void nfa_mark_resized(void* h) { static_cast<Nfa*>(h)->resized = true; }

// out[0]=n_dirty_states out[1]=n_dirty_buckets out[2]=resized out[3]=epoch
void nfa_delta_sizes(void* h, int64_t* out) {
  Nfa* n = static_cast<Nfa*>(h);
  out[0] = n->resized ? 0 : int64_t(n->dirty_states.size());
  out[1] = n->resized ? 0 : int64_t(n->dirty_buckets.size());
  out[2] = n->resized ? 1 : 0;
  out[3] = int64_t(n->epoch);
}

// fills dirty row indices + current row contents, then clears dirty sets
void nfa_delta_fill(void* h, int32_t* state_idx, int32_t* state_rows,
                    int32_t* bucket_idx, int32_t* bucket_rows) {
  Nfa* n = static_cast<Nfa*>(h);
  if (!n->resized) {
    int64_t i = 0;
    for (int32_t sid : n->dirty_states) {
      state_idx[i] = sid;
      int32_t* row = state_rows + i * 4;
      if (size_t(sid) < n->nodes.size() && n->nodes[sid].live) {
        row[0] = n->nodes[sid].plus;
        row[1] = n->nodes[sid].hash_aid;
        row[2] = n->nodes[sid].aid;
        row[3] = 0;
      } else {
        row[0] = row[1] = row[2] = -1;
        row[3] = 0;
      }
      ++i;
    }
    int64_t j = 0;
    for (int32_t b : n->dirty_buckets) {
      bucket_idx[j] = b;
      std::memcpy(bucket_rows + j * ROW, &n->edge_tab[size_t(b) * ROW],
                  ROW * sizeof(int32_t));
      ++j;
    }
  }
  n->dirty_states.clear();
  n->dirty_buckets.clear();
  n->resized = false;
}

}  // extern "C"
