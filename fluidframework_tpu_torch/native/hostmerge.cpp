// Native host merge-tree engine: the interactive-client hot path.
//
// A faithful C++ port of the scalar oracle's segment-list semantics
// (fluidframework_tpu/core/mergetree.py MergeTreeEngine — itself the
// re-expression of reference packages/dds/merge-tree/src/mergeTree.ts
// insertingWalk/markRangeRemoved/annotateRange and client.ts:98).
// The reference runs this path in optimized JIT-compiled TypeScript;
// the Python oracle is deliberately simple and ~100x too slow to
// serve interactive clients (BENCH_DETAIL configs 1/3). This engine
// keeps the oracle's exact algorithm and data model — a document-
// ordered segment list with perspective visibility — in C++, bound
// via ctypes (core/native_engine.py), and is differentially farm-
// tested against the oracle (tests/test_native_engine.py).
//
// Content items are int32 (codepoints for text engines, handles for
// permutation vectors); property keys/values arrive pre-interned as
// int32 pairs (value PROP_DELETE encodes the reference's null-delete).
//
// Memory model: every Segment/Group is owned by engine-lifetime
// registries; the live document is a vector of raw pointers. Acked or
// zamboni-collected objects may still be referenced by pending-group
// metadata (exactly like Python object references) and stay valid
// until hm_free.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <vector>

namespace {

constexpr int32_t UNASSIGNED_SEQ = -1;
constexpr int32_t UNIVERSAL_SEQ = 0;
constexpr int32_t NON_COLLAB_CLIENT = -2;
constexpr int32_t INT32_MAX_ = 2147483647;
constexpr int32_t EFF_SEQ_NEW_LOCAL = INT32_MAX_;
constexpr int32_t EFF_SEQ_EXISTING_LOCAL = INT32_MAX_ - 1;
constexpr int32_t REMOVED_NONE = INT32_MIN;  // removed_seq: not removed
constexpr int32_t PROP_DELETE = -2;          // interned "None" value
constexpr int32_t LOCAL_NONE = -1;           // local_seq: none

// Op kinds (protocol.mergetree_ops MergeTreeDeltaType numbering).
constexpr int KIND_INSERT = 0;
constexpr int KIND_REMOVE = 1;
constexpr int KIND_ANNOTATE = 2;

enum Vis { SKIP = 0, ZERO = 1, VISIBLE = 2 };

struct Group;

struct Seg {
  std::vector<int32_t> content;
  int32_t seq = UNASSIGNED_SEQ;
  int32_t client_id = NON_COLLAB_CLIENT;
  int32_t local_seq = LOCAL_NONE;
  int32_t removed_seq = REMOVED_NONE;
  int32_t local_removed_seq = LOCAL_NONE;
  std::vector<int32_t> removed_clients;
  std::map<int32_t, int32_t> props;          // key -> value
  std::map<int32_t, int32_t> pending_props;  // key -> pending count
  std::vector<Group*> groups;
  // Per-position insert-attribution runs (offset, key): the
  // attributionCollection.ts role. One run per fresh segment (key =
  // insert seq; UNASSIGNED until ack); runs concatenate when
  // pack_settled merges segments, so attribution survives coalescing
  // exactly the way the reference's collection survives append().
  // Empty when tracking is off.
  std::vector<std::pair<int32_t, int32_t>> attr;
};

struct Group {
  int32_t id;
  int kind;
  int32_t local_seq = LOCAL_NONE;
  std::vector<std::pair<int32_t, int32_t>> props;  // annotate acks
  std::vector<Seg*> segs;
};

struct Engine {
  std::vector<std::unique_ptr<Seg>> seg_owner;
  std::vector<std::unique_ptr<Group>> grp_owner;
  std::vector<Seg*> segments;  // document order
  std::deque<Group*> pending;  // local-op FIFO (ack order)
  int32_t local_client_id = NON_COLLAB_CLIENT;
  bool collaborating = false;
  int32_t current_seq = 0;
  int32_t min_seq = 0;
  int32_t local_seq = 0;
  int32_t next_group_id = 1;

  Seg* new_seg() {
    seg_owner.push_back(std::make_unique<Seg>());
    return seg_owner.back().get();
  }
  Group* new_group(int kind) {
    grp_owner.push_back(std::make_unique<Group>());
    Group* g = grp_owner.back().get();
    g->id = next_group_id++;
    g->kind = kind;
    return g;
  }

  // ---- visibility (mergetree.py _vis / mergeTree.ts:916 nodeLength)
  Vis vis(const Seg* s, int32_t ref_seq, int32_t client, int64_t* len) const {
    bool removed = s->removed_seq != REMOVED_NONE;
    *len = 0;
    if (client == local_client_id && collaborating) {
      if (removed) {
        int64_t norm = (s->removed_seq == UNASSIGNED_SEQ)
                           ? INT64_MAX
                           : (int64_t)s->removed_seq;
        if (norm > min_seq) return ZERO;
        return SKIP;
      }
      *len = (int64_t)s->content.size();
      return VISIBLE;
    }
    if (removed && s->removed_seq != UNASSIGNED_SEQ &&
        s->removed_seq <= ref_seq)
      return SKIP;
    if (s->client_id == client ||
        (s->seq != UNASSIGNED_SEQ && s->seq <= ref_seq)) {
      if (removed) {
        for (int32_t c : s->removed_clients)
          if (c == client) return ZERO;
      }
      *len = (int64_t)s->content.size();
      return VISIBLE;
    }
    if (removed && s->removed_seq != UNASSIGNED_SEQ) return SKIP;
    return ZERO;
  }

  static int32_t eff_seq(int32_t seq) {
    return seq == UNASSIGNED_SEQ ? EFF_SEQ_EXISTING_LOCAL : seq;
  }

  // ---- split (Segment.split: tail inherits all merge metadata)
  Seg* split(Seg* s, int64_t offset) {
    Seg* tail = new_seg();
    tail->content.assign(s->content.begin() + offset, s->content.end());
    s->content.resize(offset);
    tail->seq = s->seq;
    tail->client_id = s->client_id;
    tail->local_seq = s->local_seq;
    tail->removed_seq = s->removed_seq;
    tail->local_removed_seq = s->local_removed_seq;
    tail->removed_clients = s->removed_clients;
    tail->props = s->props;
    tail->pending_props = s->pending_props;
    tail->groups = s->groups;
    for (Group* g : tail->groups) g->segs.push_back(tail);
    if (!s->attr.empty()) {
      // Slice attribution runs at the split point (the
      // attributionCollection.ts splitAt role). Run 0 starts at
      // offset 0 < offset, so i >= 1 on exit.
      size_t i = 0;
      while (i < s->attr.size() && s->attr[i].first < offset) i++;
      bool boundary_run = !(i < s->attr.size() &&
                            s->attr[i].first == offset);
      if (boundary_run)
        // Run i-1 straddles the boundary: tail starts with its key.
        tail->attr.push_back({0, s->attr[i - 1].second});
      for (size_t k = i; k < s->attr.size(); k++)
        tail->attr.push_back(
            {(int32_t)(s->attr[k].first - offset), s->attr[k].second});
      s->attr.resize(i);
    }
    return tail;
  }

  // ---- insert (mergetree.py insert / insertingWalk + breakTie)
  // Returns 0, or -1 for position-beyond-length.
  int insert(int64_t pos, const int32_t* items, int64_t n, int32_t ref_seq,
             int32_t client, int32_t seq, const int32_t* pkeys,
             const int32_t* pvals, int32_t nk) {
    int32_t eff_new = (seq == UNASSIGNED_SEQ) ? EFF_SEQ_NEW_LOCAL : seq;
    int32_t lseq = LOCAL_NONE;
    if (seq == UNASSIGNED_SEQ) lseq = ++local_seq;
    Seg* ns = new_seg();
    if (track_attr) ns->attr.push_back({0, seq});
    ns->content.assign(items, items + n);
    ns->seq = seq;
    ns->client_id = client;
    ns->local_seq = lseq;
    for (int32_t k = 0; k < nk; k++)
      if (pvals[k] != PROP_DELETE) ns->props[pkeys[k]] = pvals[k];

    int64_t remaining = pos;
    size_t insert_at = segments.size();
    bool landed = false;
    for (size_t i = 0; i < segments.size(); i++) {
      Seg* s = segments[i];
      int64_t len;
      Vis cat = vis(s, ref_seq, client, &len);
      if (cat == SKIP) continue;
      if (remaining < len) {
        if (remaining == 0) {
          insert_at = i;
        } else {
          Seg* tail = split(s, remaining);
          segments.insert(segments.begin() + i + 1, tail);
          insert_at = i + 1;
        }
        landed = true;
        break;
      }
      if (remaining == 0 && len == 0) {
        if (eff_new > eff_seq(s->seq)) {
          insert_at = i;
          landed = true;
          break;
        }
        continue;
      }
      remaining -= len;
    }
    if (!landed) {
      if (remaining > 0) return -1;
      insert_at = segments.size();
    }
    segments.insert(segments.begin() + insert_at, ns);
    if (seq == UNASSIGNED_SEQ) {
      Group* g = new_group(KIND_INSERT);
      g->local_seq = lseq;
      g->segs.push_back(ns);
      ns->groups.push_back(g);
      pending.push_back(g);
    }
    return 0;
  }

  // ---- boundary split (ensureIntervalBoundary)
  void ensure_boundary(int64_t pos, int32_t ref_seq, int32_t client) {
    int64_t remaining = pos;
    for (size_t i = 0; i < segments.size(); i++) {
      Seg* s = segments[i];
      int64_t len;
      Vis cat = vis(s, ref_seq, client, &len);
      if (cat == SKIP) continue;
      if (remaining < len) {
        if (remaining > 0) {
          Seg* tail = split(s, remaining);
          segments.insert(segments.begin() + i + 1, tail);
        }
        return;
      }
      remaining -= len;
    }
  }

  // ---- remove (mergetree.py remove_range / markRangeRemoved)
  int remove_range(int64_t start, int64_t end, int32_t ref_seq,
                   int32_t client, int32_t seq) {
    if (!(end > start && start >= 0)) return -1;
    ensure_boundary(start, ref_seq, client);
    ensure_boundary(end, ref_seq, client);
    int32_t lseq = LOCAL_NONE;
    if (seq == UNASSIGNED_SEQ) lseq = ++local_seq;
    std::vector<Seg*> newly_ours;
    int64_t pos = 0;
    for (Seg* s : segments) {
      if (pos >= end) break;
      int64_t len;
      Vis cat = vis(s, ref_seq, client, &len);
      if (cat == SKIP || len == 0) continue;
      if (pos >= start) {
        if (s->removed_seq != REMOVED_NONE) {
          if (s->removed_seq == UNASSIGNED_SEQ) {
            // Our pending local remove lost the race.
            s->removed_clients.insert(s->removed_clients.begin(), client);
            s->removed_seq = seq;
            note_tomb(seq);
          } else {
            s->removed_clients.push_back(client);
          }
        } else {
          s->removed_seq = seq;
          s->removed_clients.assign(1, client);
          s->local_removed_seq = lseq;
          if (seq == UNASSIGNED_SEQ) newly_ours.push_back(s);
          else note_tomb(seq);
        }
      }
      pos += len;
    }
    if (seq == UNASSIGNED_SEQ) {
      Group* g = new_group(KIND_REMOVE);
      g->local_seq = lseq;
      for (Seg* s : newly_ours) {
        g->segs.push_back(s);
        s->groups.push_back(g);
      }
      pending.push_back(g);
    }
    return 0;
  }

  // ---- annotate (mergetree.py annotate_range / annotateRange;
  // pending-shadow rule from segmentPropertiesManager.ts)
  int annotate_range(int64_t start, int64_t end, const int32_t* pkeys,
                     const int32_t* pvals, int32_t nk, int32_t ref_seq,
                     int32_t client, int32_t seq) {
    if (!(end > start && start >= 0)) return -1;
    ensure_boundary(start, ref_seq, client);
    ensure_boundary(end, ref_seq, client);
    bool is_local = seq == UNASSIGNED_SEQ;
    if (is_local) ++local_seq;
    std::vector<Seg*> touched;
    int64_t pos = 0;
    for (Seg* s : segments) {
      if (pos >= end) break;
      int64_t len;
      Vis cat = vis(s, ref_seq, client, &len);
      if (cat == SKIP || len == 0) continue;
      if (pos >= start) {
        for (int32_t k = 0; k < nk; k++) {
          int32_t key = pkeys[k], val = pvals[k];
          if (is_local) {
            s->pending_props[key] += 1;
            if (val == PROP_DELETE)
              s->props.erase(key);
            else
              s->props[key] = val;
          } else {
            auto it = s->pending_props.find(key);
            if (it != s->pending_props.end() && it->second > 0)
              continue;  // shadowed by pending local write
            if (val == PROP_DELETE)
              s->props.erase(key);
            else
              s->props[key] = val;
          }
        }
        touched.push_back(s);
      }
      pos += len;
    }
    if (is_local) {
      Group* g = new_group(KIND_ANNOTATE);
      g->local_seq = local_seq;
      for (int32_t k = 0; k < nk; k++) g->props.push_back({pkeys[k], pvals[k]});
      for (Seg* s : touched) {
        g->segs.push_back(s);
        s->groups.push_back(g);
      }
      pending.push_back(g);
    }
    return 0;
  }

  // ---- ack (mergetree.py ack / ackPendingSegment)
  int ack(int32_t seq) {
    if (pending.empty()) return -1;
    Group* g = pending.front();
    pending.pop_front();
    for (Seg* s : g->segs)
      s->groups.erase(std::remove(s->groups.begin(), s->groups.end(), g),
                      s->groups.end());
    if (g->kind == KIND_INSERT) {
      for (Seg* s : g->segs) {
        s->seq = seq;
        s->local_seq = LOCAL_NONE;
        for (auto& run : s->attr)
          if (run.second == UNASSIGNED_SEQ) run.second = seq;
      }
    } else if (g->kind == KIND_REMOVE) {
      for (Seg* s : g->segs) {
        if (s->removed_seq == UNASSIGNED_SEQ) {
          s->removed_seq = seq;
          note_tomb(seq);
        }
        // else: an overlapping remote remove owns removed_seq.
        s->local_removed_seq = LOCAL_NONE;
      }
    } else {
      for (Seg* s : g->segs) {
        for (auto& kv : g->props) {
          auto it = s->pending_props.find(kv.first);
          if (it != s->pending_props.end() && it->second > 0) {
            if (it->second == 1)
              s->pending_props.erase(it);
            else
              it->second -= 1;
          }
        }
      }
    }
    return 0;
  }

  // Insert-attribution tracking (attributionPolicy.ts role); opt-in
  // because every segment then carries a run vector.
  bool track_attr = false;
  void enable_attr_tracking() {
    if (track_attr) return;
    track_attr = true;
    // Backfill existing segments: preloaded content attributes to
    // key 0 (the "detached/load" attribution), sequenced segments to
    // their insert seq, pending locals to UNASSIGNED (acks fill it).
    for (Seg* s : segments)
      if (s->attr.empty())
        s->attr.push_back(
            {0, s->seq == UNASSIGNED_SEQ ? UNASSIGNED_SEQ
                 : (s->client_id == NON_COLLAB_CLIENT ? 0 : s->seq)});
  }

  // Smallest acked removed_seq still in the list (INT32_MAX_ when no
  // collectible tombstone exists) — lets update_min_seq run O(1) per
  // message until the MSN actually passes a tombstone.
  int32_t min_tomb = INT32_MAX_;
  void note_tomb(int32_t s) {
    if (s < min_tomb) min_tomb = s;
  }

  // ---- windows (mergetree.py update_min_seq; zamboni.ts:19)
  void update_min_seq(int32_t new_min) {
    min_seq = new_min;
    if (min_tomb <= new_min) {
      std::vector<Seg*> kept;
      kept.reserve(segments.size());
      min_tomb = INT32_MAX_;
      for (Seg* s : segments) {
        bool acked_tomb = s->removed_seq != REMOVED_NONE &&
                          s->removed_seq != UNASSIGNED_SEQ;
        if (acked_tomb && s->removed_seq <= new_min) continue;
        if (acked_tomb) note_tomb(s->removed_seq);
        kept.push_back(s);
      }
      segments.swap(kept);
    }
    maybe_autopack();
  }

  // Merge adjacent fully-settled same-props segments (the
  // zamboni.ts:19 packParent role). Settled segments (acked at or
  // below min_seq, not removed, no live pending-group references —
  // `groups` holds exactly the UNacked groups, ack() removes itself
  // from every member) are indistinguishable to every valid future
  // perspective (any refSeq >= MSN sees them), and nothing can later
  // address them through a group, so merging preserves all
  // visibility/position/ack semantics for interactive engines too.
  // Runs are capped so a later insert that lands inside settled
  // content splits an O(cap) segment, not an O(document) one (the
  // reference likewise packs under a segment-size budget).
  static constexpr size_t PACK_RUN_CAP = 4096;
  void pack_settled() {
    std::vector<Seg*> kept;
    kept.reserve(segments.size());
    Seg* run = nullptr;
    for (Seg* s : segments) {
      bool settled = s->seq != UNASSIGNED_SEQ && s->seq <= min_seq &&
                     s->removed_seq == REMOVED_NONE &&
                     s->pending_props.empty() && s->groups.empty();
      if (settled && run != nullptr && run->props == s->props &&
          run->content.size() + s->content.size() <= PACK_RUN_CAP) {
        int32_t base = (int32_t)run->content.size();
        run->content.insert(run->content.end(), s->content.begin(),
                            s->content.end());
        for (auto& r : s->attr) {
          int32_t off = base + r.first;
          if (!run->attr.empty() && run->attr.back().second == r.second)
            continue;  // coalesce equal adjacent keys
          run->attr.push_back({off, r.second});
        }
        continue;
      }
      kept.push_back(s);
      run = settled ? s : nullptr;
    }
    segments.swap(kept);
  }

  // Growth-triggered packing: amortized O(1) per op, keeps the
  // per-op document walks O(collab window + doc/PACK_RUN_CAP) the way
  // the reference's zamboni + B-tree bound them.
  size_t pack_watermark = 64;
  void maybe_autopack() {
    if (segments.size() >= pack_watermark * 2) {
      pack_settled();
      pack_watermark = std::max<size_t>(64, segments.size());
    }
  }

  // ---- queries
  int64_t visible_length(int32_t ref_seq, int32_t client) const {
    int64_t total = 0, len;
    for (const Seg* s : segments) {
      vis(s, ref_seq, client, &len);
      total += len;
    }
    return total;
  }

  int64_t item_at(int64_t pos, int32_t ref_seq, int32_t client) const {
    int64_t remaining = pos, len;
    for (const Seg* s : segments) {
      Vis cat = vis(s, ref_seq, client, &len);
      if (cat == SKIP || len == 0) continue;
      if (remaining < len) return s->content[remaining];
      remaining -= len;
    }
    return -1;
  }

  int64_t position_of_item(int32_t item, int32_t ref_seq,
                           int32_t client) const {
    int64_t pos = 0, len;
    for (const Seg* s : segments) {
      Vis cat = vis(s, ref_seq, client, &len);
      if (cat == SKIP || len == 0) continue;
      for (size_t j = 0; j < s->content.size(); j++)
        if (s->content[j] == item) return pos + (int64_t)j;
      pos += len;
    }
    return -1;
  }

  // ---- reconnect rebase (mergetree.py regenerate_pending /
  // client.ts:917 regeneratePendingOp). See the Python docstring for
  // the group-splitting contract; the wire encoding is
  // [kind, grp_id, a, b, n_items, items...]* (insert: a=pos; range
  // ops: a=start, b=end).
  int32_t group_fifo_index(const Group* g) const {
    for (size_t i = 0; i < pending.size(); i++)
      if (pending[i] == g) return (int32_t)i;
    return -1;
  }

  int32_t group_index_of_kind(const Seg* s, int kind) const {
    for (Group* g : s->groups)
      if (g->kind == kind) return group_fifo_index(g);
    return -1;
  }

  int64_t reg_vis_len(const Seg* s, int32_t idx) const {
    if (s->seq == UNASSIGNED_SEQ) {
      int32_t gi = group_index_of_kind(s, KIND_INSERT);
      if (gi < 0 || gi >= idx) return 0;
    }
    if (s->removed_seq != REMOVED_NONE) {
      if (s->removed_seq != UNASSIGNED_SEQ) return 0;
      int32_t gi = group_index_of_kind(s, KIND_REMOVE);
      if (gi >= 0 && gi < idx) return 0;
    }
    return (int64_t)s->content.size();
  }

  int64_t base_pos(const Seg* target, int32_t idx) const {
    int64_t total = 0;
    for (const Seg* s : segments) {
      if (s == target) return total;
      total += reg_vis_len(s, idx);
    }
    return -1;
  }

  bool regenerate_one(Group* g, std::vector<int32_t>& out) {
    int32_t idx = group_fifo_index(g);
    if (idx < 0) return true;  // sequenced during catch-up
    std::map<const Seg*, size_t> seg_pos;
    for (size_t i = 0; i < segments.size(); i++) seg_pos[segments[i]] = i;
    std::vector<Seg*> segs;
    for (Seg* s : g->segs)
      if (seg_pos.count(s)) segs.push_back(s);
    std::sort(segs.begin(), segs.end(), [&](Seg* a, Seg* b) {
      return seg_pos[a] < seg_pos[b];
    });
    for (Seg* s : segs) s->client_id = local_client_id;

    if (g->kind == KIND_INSERT) {
      if (segs.empty()) {
        pending.erase(
            std::remove(pending.begin(), pending.end(), g), pending.end());
        return true;
      }
      int64_t pos = base_pos(segs[0], idx);
      out.push_back(KIND_INSERT);
      out.push_back(g->id);
      out.push_back((int32_t)pos);
      out.push_back(0);
      size_t nslot = out.size();
      out.push_back(0);
      int32_t n = 0;
      for (Seg* s : segs)
        for (int32_t it : s->content) {
          out.push_back(it);
          n++;
        }
      out[nslot] = n;
      return true;
    }

    // Range ops: drop members whose removal has sequenced.
    std::vector<Seg*> live;
    for (Seg* s : segs)
      if (!(s->removed_seq != REMOVED_NONE &&
            s->removed_seq != UNASSIGNED_SEQ))
        live.push_back(s);
    if (live.empty()) {
      pending.erase(
          std::remove(pending.begin(), pending.end(), g), pending.end());
      return true;
    }
    // Split: one per-segment group replacing the original at idx.
    pending.erase(
        std::remove(pending.begin(), pending.end(), g), pending.end());
    std::vector<Group*> new_groups;
    for (Seg* s : live) {
      Group* ng = new_group(g->kind);
      ng->local_seq = g->local_seq;
      ng->props = g->props;
      ng->segs.push_back(s);
      s->groups.erase(std::remove(s->groups.begin(), s->groups.end(), g),
                      s->groups.end());
      s->groups.push_back(ng);
      new_groups.push_back(ng);
    }
    pending.insert(pending.begin() + idx, new_groups.begin(),
                   new_groups.end());

    int64_t removed_before = 0;
    for (size_t i = 0; i < live.size(); i++) {
      Seg* s = live[i];
      int64_t start = base_pos(s, idx) - removed_before;
      int64_t end = start + (int64_t)s->content.size();
      out.push_back(g->kind);
      out.push_back(new_groups[i]->id);
      out.push_back((int32_t)start);
      out.push_back((int32_t)end);
      out.push_back(0);
      if (g->kind == KIND_REMOVE) removed_before += (int64_t)s->content.size();
    }
    return true;
  }
};

Engine* E(void* h) { return static_cast<Engine*>(h); }

}  // namespace

extern "C" {

void* hm_new(int32_t client_id) {
  Engine* e = new Engine();
  e->local_client_id = client_id;
  e->collaborating = client_id != NON_COLLAB_CLIENT;
  return e;
}

void hm_free(void* h) { delete E(h); }

void hm_set_identity(void* h, int32_t cid, int32_t collaborating) {
  E(h)->local_client_id = cid;
  E(h)->collaborating = collaborating != 0;
}

void hm_load(void* h, const int32_t* items, int64_t n) {
  if (n <= 0) return;
  Engine* e = E(h);
  Seg* s = e->new_seg();
  s->content.assign(items, items + n);
  s->seq = UNIVERSAL_SEQ;
  s->client_id = NON_COLLAB_CLIENT;
  if (e->track_attr) s->attr.push_back({0, 0});
  e->segments.push_back(s);
}

void hm_enable_attr(void* h) { E(h)->enable_attr_tracking(); }

// Per-position insert-attribution runs over the visible document:
// flat stream of (run_len, key) pairs (adjacent equal keys NOT merged
// across segments — callers normalize). Two-call sizing like hm_spans.
int64_t hm_attr_spans(void* h, int32_t* out, int64_t cap) {
  Engine* e = E(h);
  int64_t n = 0;
  auto put = [&](int32_t v) {
    if (out && n < cap) out[n] = v;
    n++;
  };
  for (const Seg* s : e->segments) {
    if (s->removed_seq != REMOVED_NONE) continue;
    int64_t len = (int64_t)s->content.size();
    if (len == 0) continue;
    if (s->attr.empty()) {
      put((int32_t)len);
      put(s->seq);
      continue;
    }
    for (size_t i = 0; i < s->attr.size(); i++) {
      int64_t end = (i + 1 < s->attr.size()) ? s->attr[i + 1].first : len;
      put((int32_t)(end - s->attr[i].first));
      put(s->attr[i].second);
    }
  }
  return n;
}

int32_t hm_current_seq(void* h) { return E(h)->current_seq; }
void hm_set_current_seq(void* h, int32_t v) { E(h)->current_seq = v; }
int32_t hm_min_seq(void* h) { return E(h)->min_seq; }
void hm_set_min_seq(void* h, int32_t v) { E(h)->min_seq = v; }
int32_t hm_local_client(void* h) { return E(h)->local_client_id; }
int32_t hm_collaborating(void* h) { return E(h)->collaborating ? 1 : 0; }
int64_t hm_segment_count(void* h) { return (int64_t)E(h)->segments.size(); }

int32_t hm_insert(void* h, int64_t pos, const int32_t* items, int64_t n,
                  int32_t ref_seq, int32_t client, int32_t seq,
                  const int32_t* pkeys, const int32_t* pvals, int32_t nk) {
  return E(h)->insert(pos, items, n, ref_seq, client, seq, pkeys, pvals, nk);
}

int32_t hm_remove(void* h, int64_t start, int64_t end, int32_t ref_seq,
                  int32_t client, int32_t seq) {
  return E(h)->remove_range(start, end, ref_seq, client, seq);
}

int32_t hm_annotate(void* h, int64_t start, int64_t end, const int32_t* pkeys,
                    const int32_t* pvals, int32_t nk, int32_t ref_seq,
                    int32_t client, int32_t seq) {
  return E(h)->annotate_range(start, end, pkeys, pvals, nk, ref_seq, client,
                              seq);
}

int32_t hm_ack(void* h, int32_t seq) { return E(h)->ack(seq); }

void hm_pack_settled(void* h) { E(h)->pack_settled(); }

// Batched sequenced-message application: the client.ts:858 applyMsg
// loop crossed ONCE per batch instead of once per message (the
// interactive path's bottleneck was per-op Python/ctypes frames, not
// the merge walks). Row kinds: 0 insert, 1 remove, 2 annotate,
// 3 ack (own op), 4 window-only (join/noop). Deferring the MSN to one
// update_min_seq(final_msn) at batch end is semantics-preserving:
// zamboni timing never changes visible state, and min_seq only enters
// vis() on the LOCAL perspective, which no remote apply or ack reads.
// Returns 0, or -(i+1) for the first failing row i.
int32_t hm_apply_batch(void* h, int64_t n, const int32_t* kind,
                       const int32_t* pos1, const int32_t* pos2,
                       const int32_t* ref_seq, const int32_t* client,
                       const int32_t* seq,
                       const int32_t* arena, const int32_t* aoff,
                       const int32_t* alen,
                       const int32_t* pk, const int32_t* pv,
                       const int32_t* poff, int32_t final_msn) {
  Engine* e = E(h);
  for (int64_t i = 0; i < n; ++i) {
    int rc = 0;
    switch (kind[i]) {
      case 0:
        rc = e->insert(pos1[i], arena + aoff[i], alen[i], ref_seq[i],
                       client[i], seq[i], pk + poff[i],
                       pv + poff[i], poff[i + 1] - poff[i]);
        break;
      case 1:
        rc = e->remove_range(pos1[i], pos2[i], ref_seq[i], client[i],
                             seq[i]);
        break;
      case 2:
        rc = e->annotate_range(pos1[i], pos2[i], pk + poff[i],
                               pv + poff[i], poff[i + 1] - poff[i],
                               ref_seq[i], client[i], seq[i]);
        break;
      case 3:
        rc = e->ack(seq[i]);
        break;
      case 4:
        break;
      default:
        rc = -1;
    }
    if (rc != 0) return (int32_t)(-(i + 1));
    e->current_seq = seq[i];
  }
  if (final_msn > e->min_seq) e->update_min_seq(final_msn);
  else e->maybe_autopack();
  return 0;
}

void hm_update_min_seq(void* h, int32_t min_seq) {
  E(h)->update_min_seq(min_seq);
}

int64_t hm_visible_length(void* h, int32_t ref_seq, int32_t client) {
  return E(h)->visible_length(ref_seq, client);
}

// Visible content at the LOCAL materialized view (removed_seq unset),
// matching the oracle's get_text/get_items.
int64_t hm_get_items(void* h, int32_t* out, int64_t cap) {
  Engine* e = E(h);
  int64_t n = 0;
  for (const Seg* s : e->segments) {
    if (s->removed_seq != REMOVED_NONE) continue;
    for (int32_t it : s->content) {
      if (out && n < cap) out[n] = it;
      n++;
    }
  }
  return n;
}

int64_t hm_item_at(void* h, int64_t pos, int32_t ref_seq, int32_t client) {
  return E(h)->item_at(pos, ref_seq, client);
}

int64_t hm_position_of_item(void* h, int32_t item, int32_t ref_seq,
                            int32_t client) {
  return E(h)->position_of_item(item, ref_seq, client);
}

// Annotated spans of the local materialized view, flat-encoded per
// visible segment: [n_items, items..., n_props, key, val, ...]*.
int64_t hm_spans(void* h, int32_t* out, int64_t cap) {
  Engine* e = E(h);
  int64_t n = 0;
  auto put = [&](int32_t v) {
    if (out && n < cap) out[n] = v;
    n++;
  };
  for (const Seg* s : e->segments) {
    if (s->removed_seq != REMOVED_NONE) continue;
    put((int32_t)s->content.size());
    for (int32_t it : s->content) put(it);
    put((int32_t)s->props.size());
    for (auto& kv : s->props) {
      put(kv.first);
      put(kv.second);
    }
  }
  return n;
}

int64_t hm_pending_count(void* h) { return (int64_t)E(h)->pending.size(); }

// Structural invariant verification (the mergetree.py
// verify_invariants role; reference partialLengths.ts:336 verifier).
// Returns 0 when sound, else a small positive violation code.
int32_t hm_verify(void* h) {
  Engine* e = E(h);
  if (e->min_seq > e->current_seq) return 1;
  for (const Seg* s : e->segments) {
    if (s->content.empty()) return 2;
    if (s->removed_seq == REMOVED_NONE) {
      if (!s->removed_clients.empty()) return 3;
    } else if (s->removed_seq == UNASSIGNED_SEQ) {
      if (s->local_removed_seq == LOCAL_NONE && s->groups.empty()) return 4;
    } else {
      if (s->removed_clients.empty()) return 5;
      if (!(s->removed_seq >= s->seq || s->seq == UNASSIGNED_SEQ)) return 6;
    }
    if (s->seq == UNASSIGNED_SEQ && s->client_id != e->local_client_id)
      return 7;
    for (const Group* g : s->groups) {
      bool found = false;
      for (const Group* p : e->pending)
        if (p == g) found = true;
      if (!found) return 8;
    }
  }
  // Visible length at the local head must equal materialized length.
  int64_t mat = 0;
  for (const Seg* s : e->segments)
    if (s->removed_seq == REMOVED_NONE) mat += (int64_t)s->content.size();
  if (e->visible_length(e->current_seq, e->local_client_id) != mat) return 9;
  return 0;
}

// Upper bound on hm_regenerate's output size (regeneration mutates
// state, so callers must size the buffer BEFORE the single call).
int64_t hm_content_total(void* h) {
  int64_t total = 0;
  for (const Seg* s : E(h)->segments) total += (int64_t)s->content.size();
  return total;
}

int32_t hm_pending_last_id(void* h) {
  Engine* e = E(h);
  return e->pending.empty() ? -1 : e->pending.back()->id;
}

int64_t hm_group_props(void* h, int32_t grp_id, int32_t* out, int64_t cap) {
  Engine* e = E(h);
  for (auto& g : e->grp_owner)
    if (g->id == grp_id) {
      int64_t n = 0;
      for (auto& kv : g->props) {
        if (out && n + 1 < cap) {
          out[n] = kv.first;
          out[n + 1] = kv.second;
        }
        n += 2;
      }
      return n;
    }
  return -1;
}

// Regenerate the pending ops backed by `grp_ids` for resubmission
// after reconnect. Returns the number of int32s written (flat op
// stream, see Engine::regenerate_one), or -1 on unknown group id.
int64_t hm_regenerate(void* h, const int32_t* grp_ids, int32_t n_grps,
                      int32_t* out, int64_t cap) {
  Engine* e = E(h);
  std::vector<int32_t> buf;
  for (int32_t i = 0; i < n_grps; i++) {
    Group* g = nullptr;
    for (auto& og : e->grp_owner)
      if (og->id == grp_ids[i]) {
        g = og.get();
        break;
      }
    if (!g) return -1;
    e->regenerate_one(g, buf);
  }
  for (size_t i = 0; i < buf.size(); i++)
    if (out && (int64_t)i < cap) out[i] = buf[i];
  return (int64_t)buf.size();
}

}  // extern "C"
