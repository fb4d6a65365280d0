// Native grammar engine: byte-level Earley recognizer + vocab-trie token
// masking.  C++ twin of the Python Earley engine in grammar.py (same
// lowered-grammar semantics, same tests), providing the per-decode-step
// hot path the reference gets from the compiled `kbnf` crate
// (crates/ai00-core/src/sampler/bnf.rs): computing the set of allowed
// vocabulary tokens means walking a ~400k-node byte trie against the
// Earley state — far too slow in Python at 65k vocab.
//
// Host code, not a GPU kernel: built with g++ and exposed as a C ABI
// consumed via ctypes (ai00_server_tpu_torch/native.py).
//
// Lowered grammar serialization (int64 array):
//   [n_nts, then per nt: n_alts, per alt: n_syms, syms...]
//   sym >= 0  -> nonterminal id
//   sym <  0  -> byte-class id = -(sym+1) into the classes table
// Byte classes: 4x uint64 little-endian bitmask per class.
//
// Vocab trie (CSR): edge_start[n_nodes+1], edge_byte[], edge_target[],
// accept[n_nodes] (0 = none).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <map>
#include <unordered_set>
#include <vector>

namespace {

struct ByteClass {
    uint64_t bits[4];
    bool test(uint8_t b) const {
        return (bits[b >> 6] >> (b & 63)) & 1ull;
    }
};

// Item packing: nt(14) | alt(8) | dot(10) | origin(32)
static inline uint64_t pack(uint32_t nt, uint32_t alt, uint32_t dot,
                            uint32_t origin) {
    return (uint64_t(nt) << 50) | (uint64_t(alt) << 42) |
           (uint64_t(dot) << 32) | origin;
}
static inline uint32_t item_nt(uint64_t it) { return uint32_t(it >> 50); }
static inline uint32_t item_alt(uint64_t it) {
    return uint32_t(it >> 42) & 0xFF;
}
static inline uint32_t item_dot(uint64_t it) {
    return uint32_t(it >> 32) & 0x3FF;
}
static inline uint32_t item_origin(uint64_t it) { return uint32_t(it); }

struct Grammar {
    // rules[nt][alt] = symbol vector
    std::vector<std::vector<std::vector<int64_t>>> rules;
    std::vector<ByteClass> classes;
    int root_nt;  // synthetic __root with single alt [start]
};

struct ItemSet {
    std::vector<uint64_t> items;          // insertion order
    std::unordered_set<uint64_t> index;   // dedup
    bool insert(uint64_t it) {
        if (index.insert(it).second) {
            items.push_back(it);
            return true;
        }
        return false;
    }
};

struct Engine {
    const Grammar* g;
    std::vector<ItemSet> chart;
    bool dead = false;
    // Mask cache: canonical current-set -> allowed token ids.  Safe
    // because item origins are absolute indices into an append-only
    // chart: an identical canonical set implies identical reachable
    // history, hence an identical mask.  Origins equal to the current
    // position are self-referential and canonicalized to ~0u.
    std::map<std::vector<uint64_t>, std::vector<int32_t>> mask_cache;

    std::vector<uint64_t> canonical_current() const {
        uint32_t cur = uint32_t(chart.size()) - 1;
        std::vector<uint64_t> key;
        key.reserve(chart.back().items.size());
        for (uint64_t it : chart.back().items) {
            uint32_t origin = item_origin(it);
            key.push_back(pack(item_nt(it), item_alt(it), item_dot(it),
                               origin == cur ? 0xFFFFFFFFu : origin));
        }
        std::sort(key.begin(), key.end());
        return key;
    }

    const std::vector<int64_t>& body(uint64_t it) const {
        return g->rules[item_nt(it)][item_alt(it)];
    }

    // Predict+complete closure into `into` at position pos.
    void closure(std::vector<uint64_t> work, ItemSet& into, uint32_t pos) {
        std::unordered_set<uint32_t> completed_here;
        while (!work.empty()) {
            uint64_t it = work.back();
            work.pop_back();
            if (!into.insert(it)) continue;
            const auto& b = body(it);
            uint32_t dot = item_dot(it);
            if (dot < b.size()) {
                int64_t sym = b[dot];
                if (sym >= 0) {
                    uint32_t nt = uint32_t(sym);
                    for (uint32_t a = 0; a < g->rules[nt].size(); ++a)
                        work.push_back(pack(nt, a, 0, pos));
                    if (completed_here.count(nt))
                        work.push_back(pack(item_nt(it), item_alt(it),
                                            dot + 1, item_origin(it)));
                }
            } else {
                uint32_t nt = item_nt(it);
                uint32_t origin = item_origin(it);
                if (origin == pos) {
                    completed_here.insert(nt);
                    // advance waiting items already in `into`
                    std::vector<uint64_t> snapshot = into.items;
                    for (uint64_t par : snapshot) {
                        const auto& pb = body(par);
                        uint32_t pd = item_dot(par);
                        if (pd < pb.size() && pb[pd] == int64_t(nt))
                            work.push_back(pack(item_nt(par), item_alt(par),
                                                pd + 1, item_origin(par)));
                    }
                } else {
                    for (uint64_t par : chart[origin].items) {
                        const auto& pb = body(par);
                        uint32_t pd = item_dot(par);
                        if (pd < pb.size() && pb[pd] == int64_t(nt))
                            work.push_back(pack(item_nt(par), item_alt(par),
                                                pd + 1, item_origin(par)));
                    }
                }
            }
        }
    }

    // One byte step from the current last set; appends nothing.
    ItemSet scan(uint8_t byte) {
        ItemSet out;
        std::vector<uint64_t> moved;
        uint32_t pos = uint32_t(chart.size());
        for (uint64_t it : chart.back().items) {
            const auto& b = body(it);
            uint32_t dot = item_dot(it);
            if (dot < b.size() && b[dot] < 0) {
                const ByteClass& bc = g->classes[size_t(-(b[dot] + 1))];
                if (bc.test(byte))
                    moved.push_back(pack(item_nt(it), item_alt(it), dot + 1,
                                         item_origin(it)));
            }
        }
        if (!moved.empty()) closure(std::move(moved), out, pos);
        return out;
    }

    bool advance(const uint8_t* bytes, int n) {
        if (dead) return false;
        for (int i = 0; i < n; ++i) {
            ItemSet next = scan(bytes[i]);
            if (next.items.empty()) {
                dead = true;
                return false;
            }
            chart.push_back(std::move(next));
        }
        return true;
    }

    bool can_finish() const {
        for (uint64_t it : chart.back().items)
            if (int(item_nt(it)) == g->root_nt && item_dot(it) == 1)
                return true;
        return false;
    }

    // 256-bit allowed-byte mask of an item set (union of next classes).
    void set_allowed_mask(const ItemSet& s, uint64_t out[4]) const {
        out[0] = out[1] = out[2] = out[3] = 0;
        for (uint64_t it : s.items) {
            const auto& b = body(it);
            uint32_t dot = item_dot(it);
            if (dot < b.size() && b[dot] < 0) {
                const ByteClass& bc = g->classes[size_t(-(b[dot] + 1))];
                for (int w = 0; w < 4; ++w) out[w] |= bc.bits[w];
            }
        }
    }

    void allowed_bytes(uint8_t out[256]) const {
        uint64_t mask[4];
        set_allowed_mask(chart.back(), mask);
        for (int byte = 0; byte < 256; ++byte)
            out[byte] = uint8_t((mask[byte >> 6] >> (byte & 63)) & 1ull);
    }
};

struct Trie {
    std::vector<int32_t> edge_start;   // n_nodes + 1
    std::vector<uint8_t> edge_byte;
    std::vector<int32_t> edge_target;
    std::vector<int32_t> accept;
};

}  // namespace

extern "C" {

void* grammar_new(const int64_t* data, int64_t len, const uint64_t* classes,
                  int64_t n_classes, int64_t start_nt) {
    auto* g = new Grammar();
    g->classes.resize(size_t(n_classes));
    for (int64_t i = 0; i < n_classes; ++i)
        std::memcpy(g->classes[size_t(i)].bits, classes + 4 * i,
                    4 * sizeof(uint64_t));
    int64_t p = 0;
    int64_t n_nts = data[p++];
    g->rules.resize(size_t(n_nts) + 1);  // +1 for __root
    for (int64_t nt = 0; nt < n_nts; ++nt) {
        int64_t n_alts = data[p++];
        auto& alts = g->rules[size_t(nt)];
        alts.resize(size_t(n_alts));
        for (int64_t a = 0; a < n_alts; ++a) {
            int64_t n_syms = data[p++];
            alts[size_t(a)].assign(data + p, data + p + n_syms);
            p += n_syms;
        }
    }
    (void)len;
    g->root_nt = int(n_nts);
    g->rules[size_t(n_nts)] = {{start_nt}};
    return g;
}

void grammar_free_grammar(void* gp) { delete static_cast<Grammar*>(gp); }

void* engine_new(void* gp) {
    auto* e = new Engine();
    e->g = static_cast<Grammar*>(gp);
    ItemSet s0;
    e->closure({pack(uint32_t(e->g->root_nt), 0, 0, 0)}, s0, 0);
    e->chart.push_back(std::move(s0));
    return e;
}

void engine_free(void* ep) { delete static_cast<Engine*>(ep); }

int engine_advance(void* ep, const uint8_t* bytes, int n) {
    return static_cast<Engine*>(ep)->advance(bytes, n) ? 1 : 0;
}

int engine_can_finish(void* ep) {
    auto* e = static_cast<Engine*>(ep);
    return (!e->dead && e->can_finish()) ? 1 : 0;
}

int engine_dead(void* ep) {
    return static_cast<Engine*>(ep)->dead ? 1 : 0;
}

void engine_allowed_bytes(void* ep, uint8_t* out) {
    static_cast<Engine*>(ep)->allowed_bytes(out);
}

void* trie_new(const int32_t* edge_start, const uint8_t* edge_byte,
               const int32_t* edge_target, const int32_t* accept,
               int64_t n_nodes, int64_t n_edges) {
    auto* t = new Trie();
    t->edge_start.assign(edge_start, edge_start + n_nodes + 1);
    t->edge_byte.assign(edge_byte, edge_byte + n_edges);
    t->edge_target.assign(edge_target, edge_target + n_edges);
    t->accept.assign(accept, accept + n_nodes);
    return t;
}

void trie_free(void* tp) { delete static_cast<Trie*>(tp); }

// DFS over the vocab trie extending the chart speculatively; collects
// token ids whose full byte strings the grammar accepts from the current
// state.  Returns the number of ids written.  Results are cached per
// canonical engine state (see Engine::mask_cache).
int64_t engine_allowed_tokens(void* ep, void* tp, int32_t* out,
                              int64_t max_out) {
    auto* e = static_cast<Engine*>(ep);
    auto* t = static_cast<Trie*>(tp);
    if (e->dead) return 0;

    std::vector<uint64_t> key = e->canonical_current();
    auto hit = e->mask_cache.find(key);
    if (hit != e->mask_cache.end()) {
        int64_t n = std::min<int64_t>(max_out, hit->second.size());
        std::memcpy(out, hit->second.data(), size_t(n) * sizeof(int32_t));
        return n;
    }

    std::vector<int32_t> ids;
    struct Frame {
        int32_t node;
        int32_t edge;        // next edge index to try
        uint64_t allowed[4]; // byte mask of the set this frame scans from
    };
    std::vector<Frame> stack;
    stack.push_back({0, t->edge_start[0], {0, 0, 0, 0}});
    e->set_allowed_mask(e->chart.back(), stack.back().allowed);

    while (!stack.empty()) {
        Frame& f = stack.back();
        if (f.edge >= t->edge_start[f.node + 1]) {
            stack.pop_back();
            if (!stack.empty()) e->chart.pop_back();
            continue;
        }
        int32_t eidx = f.edge++;
        uint8_t byte = t->edge_byte[size_t(eidx)];
        if (!((f.allowed[byte >> 6] >> (byte & 63)) & 1ull)) continue;
        int32_t target = t->edge_target[size_t(eidx)];
        ItemSet next = e->scan(byte);
        if (next.items.empty()) continue;
        e->chart.push_back(std::move(next));
        int32_t tok = t->accept[size_t(target)];
        if (tok) ids.push_back(tok);
        Frame nf;
        nf.node = target;
        nf.edge = t->edge_start[size_t(target)];
        e->set_allowed_mask(e->chart.back(), nf.allowed);
        stack.push_back(nf);
    }

    int64_t n = std::min<int64_t>(max_out, ids.size());
    std::memcpy(out, ids.data(), size_t(n) * sizeof(int32_t));
    if (e->mask_cache.size() < 4096)
        e->mask_cache.emplace(std::move(key), std::move(ids));
    return n;
}

}  // extern "C"
