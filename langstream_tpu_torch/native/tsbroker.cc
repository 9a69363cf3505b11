// tpustream broker — the framework's native inter-agent transport.
//
// Role parity: the reference's messaging substrate + Kafka runtime semantics
// (partitioned logs, consumer groups with rebalance, committed offsets,
// long-poll fetch, dead-letter topics created on demand by clients):
//   langstream-kafka-runtime/src/main/java/ai/langstream/kafka/runner/
//     KafkaConsumerWrapper.java:41,203 (group rebalance, contiguous commits)
//   KafkaTopicConnectionsRuntime.java:74,112,123
// The reference delegates this to an external Kafka cluster; here it is an
// in-tree, dependency-free C++17 single-threaded epoll reactor so agent pods
// have a broker wherever they run (dev laptop, CI, TPU host). Records ride
// DCN between agents; ICI collectives inside the serving agent are JAX/XLA's
// job, not this broker's.
//
// Wire protocol (all integers big-endian):
//   frame   := u32 payload_len, payload
//   request := u8 opcode, u64 request_id, body
//   reply   := u64 request_id, u8 status, body
//   str     := u16 len, bytes          (utf-8, topics/groups/clients)
//   blob    := u32 len, bytes          (record keys/values/header values)
// Statuses: 0 OK, 1 ERROR(str msg), 2 REBALANCED (consumer must re-join).
//
// Opcodes:
//   1 PRODUCE   topic, key:blob, value:blob, nheaders:u16, {str,blob}*
//               -> partition:u32, offset:u64
//   2 FETCH     topic, partition:u32, offset:u64, max_records:u32,
//               max_wait_ms:u32, group, generation:u32
//               -> nrecords:u32, {offset:u64, key, value, nheaders,{str,blob}*}*
//   3 COMMIT    group, topic, partition:u32, offset:u64     -> (empty)
//   4 COMMITTED group, topic, partition:u32                 -> offset:i64 (-1 none)
//   5 CREATE_TOPIC topic, partitions:u32                    -> (empty; idempotent)
//   6 DELETE_TOPIC topic                                    -> (empty)
//   7 LIST_TOPICS                                           -> n:u32, {topic, partitions:u32}*
//   8 JOIN_GROUP  group, topic, client_id
//               -> generation:u32, nparts:u32, partition:u32*
//   9 LEAVE_GROUP group, topic, client_id                   -> (empty)
//  10 PING                                                  -> (empty)
//  11 OFFSETS   topic, partition:u32                        -> earliest:u64, end:u64
//
// Persistence (optional --data-dir): append-only per-partition record log
// (replayed on boot) + append-only committed-offsets log (compacted on boot).

#include <arpa/inet.h>
#include <dirent.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <deque>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

uint64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             Clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------------------
// Buffer codec

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool fail = false;

  explicit Reader(const std::string& s)
      : p(reinterpret_cast<const uint8_t*>(s.data())),
        end(p + s.size()) {}

  bool need(size_t n) {
    if (static_cast<size_t>(end - p) < n) {
      fail = true;
      return false;
    }
    return true;
  }
  uint8_t u8() {
    if (!need(1)) return 0;
    return *p++;
  }
  uint16_t u16() {
    if (!need(2)) return 0;
    uint16_t v = (uint16_t(p[0]) << 8) | p[1];
    p += 2;
    return v;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                 (uint32_t(p[2]) << 8) | p[3];
    p += 4;
    return v;
  }
  uint64_t u64() {
    uint64_t hi = u32();
    uint64_t lo = u32();
    return (hi << 32) | lo;
  }
  std::string str() {
    uint16_t n = u16();
    if (!need(n)) return {};
    std::string s(reinterpret_cast<const char*>(p), n);
    p += n;
    return s;
  }
  std::string blob() {
    uint32_t n = u32();
    if (!need(n)) return {};
    std::string s(reinterpret_cast<const char*>(p), n);
    p += n;
    return s;
  }
};

struct Writer {
  std::string out;

  void u8(uint8_t v) { out.push_back(char(v)); }
  void u16(uint16_t v) {
    out.push_back(char(v >> 8));
    out.push_back(char(v));
  }
  void u32(uint32_t v) {
    out.push_back(char(v >> 24));
    out.push_back(char(v >> 16));
    out.push_back(char(v >> 8));
    out.push_back(char(v));
  }
  void u64(uint64_t v) {
    u32(uint32_t(v >> 32));
    u32(uint32_t(v));
  }
  void str(const std::string& s) {
    u16(uint16_t(s.size()));
    out += s;
  }
  void blob(const std::string& s) {
    u32(uint32_t(s.size()));
    out += s;
  }
};

// ---------------------------------------------------------------------------
// Log storage

struct RecordEntry {
  uint64_t offset;
  std::string key;
  std::string value;
  std::vector<std::pair<std::string, std::string>> headers;
};

struct Partition {
  std::deque<RecordEntry> log;
  uint64_t base = 0;  // offset of log.front()
  FILE* file = nullptr;

  uint64_t end_offset() const { return base + log.size(); }
};

struct Topic {
  std::string name;
  std::vector<Partition> parts;
  uint64_t round_robin = 0;
};

// Consumer-group state is per (group, topic): membership drives partition
// assignment; committed offsets survive membership churn (and restarts when
// --data-dir is set) — parity with Kafka consumer-group + __consumer_offsets.
struct GroupTopic {
  uint32_t generation = 0;
  std::vector<std::string> members;                       // client ids, sorted
  std::map<std::string, std::vector<uint32_t>> assigned;  // client -> parts
  std::map<uint32_t, int64_t> committed;                  // part -> next offset

  void rebalance(uint32_t nparts) {
    generation++;
    assigned.clear();
    if (members.empty()) return;
    for (uint32_t p = 0; p < nparts; p++) {
      assigned[members[p % members.size()]].push_back(p);
    }
  }
};

// ---------------------------------------------------------------------------
// Connections & parked fetches

struct ParkedFetch {
  int conn_fd;
  uint64_t request_id;
  std::string topic;
  uint32_t partition;
  uint64_t offset;
  uint32_t max_records;
  uint64_t deadline_ms;
  std::string group;
  uint32_t generation;
};

struct Conn {
  int fd;
  std::string inbuf;
  std::string outbuf;
  // group memberships held by this connection: (group, topic) -> client_id.
  std::map<std::pair<std::string, std::string>, std::string> memberships;
  bool closed = false;
};

class Broker {
 public:
  Broker(std::string data_dir) : data_dir_(std::move(data_dir)) {}

  int run(const char* host, int port);

 private:
  std::string data_dir_;
  std::unordered_map<std::string, Topic> topics_;
  std::map<std::pair<std::string, std::string>, GroupTopic> groups_;
  std::unordered_map<int, std::unique_ptr<Conn>> conns_;
  std::vector<ParkedFetch> parked_;
  FILE* offsets_file_ = nullptr;
  int epfd_ = -1;

  // --- persistence -------------------------------------------------------
  std::string part_path(const std::string& topic, uint32_t p) const {
    return data_dir_ + "/" + topic + "." + std::to_string(p) + ".log";
  }

  void load_state();
  void open_part_file(const std::string& tname, uint32_t pi, Partition& part);
  void persist_record(Partition& part, const RecordEntry& r);
  void persist_offset(const std::string& group, const std::string& topic,
                      uint32_t part, int64_t offset);

  // --- topic ops ---------------------------------------------------------
  Topic& ensure_topic(const std::string& name, uint32_t partitions);

  // --- request handling --------------------------------------------------
  void handle_frame(Conn& c, const std::string& payload);
  void reply_ok(Conn& c, uint64_t rid, const std::string& body);
  void reply_err(Conn& c, uint64_t rid, const std::string& msg);
  void reply_status(Conn& c, uint64_t rid, uint8_t status);
  void send_frame(Conn& c, const std::string& payload);

  std::string encode_records(const Partition& part, uint64_t offset,
                             uint32_t max_records, uint32_t* count);
  void try_wake_parked(const std::string& topic, uint32_t partition);
  void expire_parked(uint64_t now);
  int next_parked_timeout(uint64_t now);

  void drop_conn(int fd);
  void flush_out(Conn& c);
  void update_epoll(Conn& c);
};

void Broker::load_state() {
  if (data_dir_.empty()) return;
  mkdir(data_dir_.c_str(), 0755);
  // Replay committed offsets (compacting: last write wins).
  std::string opath = data_dir_ + "/offsets.log";
  if (FILE* f = fopen(opath.c_str(), "rb")) {
    std::string content;
    char buf[65536];
    size_t n;
    while ((n = fread(buf, 1, sizeof buf, f)) > 0) content.append(buf, n);
    fclose(f);
    Reader r(content);
    while (!r.fail && r.p < r.end) {
      std::string group = r.str();
      std::string topic = r.str();
      uint32_t part = r.u32();
      int64_t off = int64_t(r.u64());
      if (r.fail) break;  // torn tail write
      groups_[{group, topic}].committed[part] = off;
    }
  }
  offsets_file_ = fopen(opath.c_str(), "ab");
  // Replay record logs: files named <topic>.<partition>.log. Topics are
  // re-created with partition count = max index + 1.
  std::map<std::string, uint32_t> seen;  // topic -> nparts
  if (DIR* d = opendir(data_dir_.c_str())) {
    while (dirent* e = readdir(d)) {
      std::string fn = e->d_name;
      size_t dot2 = fn.rfind(".log");
      if (dot2 == std::string::npos || dot2 + 4 != fn.size()) continue;
      size_t dot1 = fn.rfind('.', dot2 - 1);
      if (dot1 == std::string::npos) continue;
      std::string tname = fn.substr(0, dot1);
      if (tname == "offsets") continue;
      uint32_t pi = uint32_t(atoi(fn.substr(dot1 + 1, dot2 - dot1 - 1).c_str()));
      auto& n = seen[tname];
      n = std::max(n, pi + 1);
    }
    closedir(d);
  }
  for (auto& [tname, nparts] : seen) {
    Topic& t = topics_[tname];
    t.name = tname;
    t.parts.resize(nparts);
    for (uint32_t pi = 0; pi < nparts; pi++) {
      std::string content;
      if (FILE* f = fopen(part_path(tname, pi).c_str(), "rb")) {
        char buf[65536];
        size_t n;
        while ((n = fread(buf, 1, sizeof buf, f)) > 0) content.append(buf, n);
        fclose(f);
      }
      Reader r(content);
      Partition& part = t.parts[pi];
      while (!r.fail && r.p < r.end) {
        RecordEntry rec;
        rec.offset = r.u64();
        rec.key = r.blob();
        rec.value = r.blob();
        uint16_t nh = r.u16();
        for (uint16_t h = 0; h < nh && !r.fail; h++) {
          std::string hk = r.str();
          rec.headers.emplace_back(hk, r.blob());
        }
        if (r.fail) break;
        if (part.log.empty()) part.base = rec.offset;
        part.log.push_back(std::move(rec));
      }
      open_part_file(tname, pi, part);
    }
  }
}

void Broker::open_part_file(const std::string& tname, uint32_t pi,
                            Partition& part) {
  if (data_dir_.empty()) return;
  part.file = fopen(part_path(tname, pi).c_str(), "ab");
}

void Broker::persist_record(Partition& part, const RecordEntry& r) {
  if (!part.file) return;
  Writer w;
  w.u64(r.offset);
  w.blob(r.key);
  w.blob(r.value);
  w.u16(uint16_t(r.headers.size()));
  for (auto& [hk, hv] : r.headers) {
    w.str(hk);
    w.blob(hv);
  }
  fwrite(w.out.data(), 1, w.out.size(), part.file);
  fflush(part.file);
}

void Broker::persist_offset(const std::string& group, const std::string& topic,
                            uint32_t part, int64_t offset) {
  if (!offsets_file_) return;
  Writer w;
  w.str(group);
  w.str(topic);
  w.u32(part);
  w.u64(uint64_t(offset));
  fwrite(w.out.data(), 1, w.out.size(), offsets_file_);
  fflush(offsets_file_);
}

Topic& Broker::ensure_topic(const std::string& name, uint32_t partitions) {
  auto it = topics_.find(name);
  if (it != topics_.end()) return it->second;
  Topic& t = topics_[name];
  t.name = name;
  t.parts.resize(std::max(1u, partitions));
  for (uint32_t pi = 0; pi < t.parts.size(); pi++) {
    open_part_file(name, pi, t.parts[pi]);
  }
  return t;
}

std::string Broker::encode_records(const Partition& part, uint64_t offset,
                                   uint32_t max_records, uint32_t* count) {
  Writer w;
  uint64_t start = std::max(offset, part.base);
  uint32_t n = 0;
  for (uint64_t o = start; o < part.end_offset() && n < max_records; o++, n++) {
    const RecordEntry& r = part.log[o - part.base];
    w.u64(r.offset);
    w.blob(r.key);
    w.blob(r.value);
    w.u16(uint16_t(r.headers.size()));
    for (auto& [hk, hv] : r.headers) {
      w.str(hk);
      w.blob(hv);
    }
  }
  *count = n;
  return w.out;
}

void Broker::send_frame(Conn& c, const std::string& payload) {
  if (c.closed) return;
  char hdr[4] = {char(payload.size() >> 24), char(payload.size() >> 16),
                 char(payload.size() >> 8), char(payload.size())};
  c.outbuf.append(hdr, 4);
  c.outbuf += payload;
  flush_out(c);
}

void Broker::reply_ok(Conn& c, uint64_t rid, const std::string& body) {
  Writer w;
  w.u64(rid);
  w.u8(0);
  w.out += body;
  send_frame(c, w.out);
}

void Broker::reply_err(Conn& c, uint64_t rid, const std::string& msg) {
  Writer w;
  w.u64(rid);
  w.u8(1);
  w.str(msg);
  send_frame(c, w.out);
}

void Broker::reply_status(Conn& c, uint64_t rid, uint8_t status) {
  Writer w;
  w.u64(rid);
  w.u8(status);
  send_frame(c, w.out);
}

void Broker::try_wake_parked(const std::string& topic, uint32_t partition) {
  for (size_t i = 0; i < parked_.size();) {
    ParkedFetch& pf = parked_[i];
    if (pf.topic != topic || pf.partition != partition) {
      i++;
      continue;
    }
    auto cit = conns_.find(pf.conn_fd);
    if (cit == conns_.end()) {
      parked_.erase(parked_.begin() + i);
      continue;
    }
    Topic& t = topics_[topic];
    Partition& part = t.parts[partition];
    uint32_t count = 0;
    std::string recs = encode_records(part, pf.offset, pf.max_records, &count);
    if (count == 0) {
      i++;
      continue;
    }
    Writer w;
    w.u32(count);
    w.out += recs;
    reply_ok(*cit->second, pf.request_id, w.out);
    parked_.erase(parked_.begin() + i);
  }
}

void Broker::expire_parked(uint64_t now) {
  for (size_t i = 0; i < parked_.size();) {
    if (parked_[i].deadline_ms > now) {
      i++;
      continue;
    }
    auto cit = conns_.find(parked_[i].conn_fd);
    if (cit != conns_.end()) {
      Writer w;
      w.u32(0);
      reply_ok(*cit->second, parked_[i].request_id, w.out);
    }
    parked_.erase(parked_.begin() + i);
  }
}

int Broker::next_parked_timeout(uint64_t now) {
  if (parked_.empty()) return 1000;
  uint64_t best = UINT64_MAX;
  for (auto& pf : parked_) best = std::min(best, pf.deadline_ms);
  if (best <= now) return 0;
  return int(std::min<uint64_t>(best - now, 1000));
}

void Broker::handle_frame(Conn& c, const std::string& payload) {
  Reader r(payload);
  uint8_t op = r.u8();
  uint64_t rid = r.u64();
  if (r.fail) return;

  switch (op) {
    case 1: {  // PRODUCE
      std::string tname = r.str();
      RecordEntry rec;
      rec.key = r.blob();
      rec.value = r.blob();
      uint16_t nh = r.u16();
      for (uint16_t h = 0; h < nh && !r.fail; h++) {
        std::string hk = r.str();
        rec.headers.emplace_back(hk, r.blob());
      }
      if (r.fail) return reply_err(c, rid, "bad produce");
      Topic& t = ensure_topic(tname, 1);
      uint32_t pi;
      if (!rec.key.empty()) {
        // FNV-1a over key — stable partition routing for keyed records.
        uint64_t h = 1469598103934665603ull;
        for (unsigned char ch : rec.key) h = (h ^ ch) * 1099511628211ull;
        pi = uint32_t(h % t.parts.size());
      } else {
        pi = uint32_t(t.round_robin++ % t.parts.size());
      }
      Partition& part = t.parts[pi];
      rec.offset = part.end_offset();
      persist_record(part, rec);
      part.log.push_back(std::move(rec));
      Writer w;
      w.u32(pi);
      w.u64(part.log.back().offset);
      reply_ok(c, rid, w.out);
      try_wake_parked(tname, pi);
      break;
    }
    case 2: {  // FETCH
      std::string tname = r.str();
      uint32_t pi = r.u32();
      uint64_t offset = r.u64();
      uint32_t maxr = r.u32();
      uint32_t wait_ms = r.u32();
      std::string group = r.str();
      uint32_t generation = r.u32();
      if (r.fail) return reply_err(c, rid, "bad fetch");
      auto tit = topics_.find(tname);
      if (tit == topics_.end() || pi >= tit->second.parts.size()) {
        return reply_err(c, rid, "unknown topic/partition " + tname);
      }
      if (!group.empty()) {
        auto git = groups_.find({group, tname});
        if (git == groups_.end() || git->second.generation != generation) {
          return reply_status(c, rid, 2);  // REBALANCED
        }
      }
      Partition& part = tit->second.parts[pi];
      uint32_t count = 0;
      std::string recs = encode_records(part, offset, maxr, &count);
      if (count == 0 && wait_ms > 0) {
        parked_.push_back({c.fd, rid, tname, pi, offset, maxr,
                           now_ms() + wait_ms, group, generation});
        break;
      }
      Writer w;
      w.u32(count);
      w.out += recs;
      reply_ok(c, rid, w.out);
      break;
    }
    case 3: {  // COMMIT
      std::string group = r.str();
      std::string tname = r.str();
      uint32_t pi = r.u32();
      uint64_t off = r.u64();
      if (r.fail) return reply_err(c, rid, "bad commit");
      groups_[{group, tname}].committed[pi] = int64_t(off);
      persist_offset(group, tname, pi, int64_t(off));
      reply_ok(c, rid, "");
      break;
    }
    case 4: {  // COMMITTED
      std::string group = r.str();
      std::string tname = r.str();
      uint32_t pi = r.u32();
      if (r.fail) return reply_err(c, rid, "bad committed");
      int64_t off = -1;
      auto git = groups_.find({group, tname});
      if (git != groups_.end()) {
        auto oit = git->second.committed.find(pi);
        if (oit != git->second.committed.end()) off = oit->second;
      }
      Writer w;
      w.u64(uint64_t(off));
      reply_ok(c, rid, w.out);
      break;
    }
    case 5: {  // CREATE_TOPIC
      std::string tname = r.str();
      uint32_t nparts = r.u32();
      if (r.fail) return reply_err(c, rid, "bad create");
      ensure_topic(tname, nparts);
      reply_ok(c, rid, "");
      break;
    }
    case 6: {  // DELETE_TOPIC
      std::string tname = r.str();
      if (r.fail) return reply_err(c, rid, "bad delete");
      auto tit = topics_.find(tname);
      if (tit != topics_.end()) {
        for (uint32_t pi = 0; pi < tit->second.parts.size(); pi++) {
          if (tit->second.parts[pi].file) fclose(tit->second.parts[pi].file);
          if (!data_dir_.empty()) unlink(part_path(tname, pi).c_str());
        }
        topics_.erase(tit);
      }
      reply_ok(c, rid, "");
      break;
    }
    case 7: {  // LIST_TOPICS
      Writer w;
      w.u32(uint32_t(topics_.size()));
      for (auto& [name, t] : topics_) {
        w.str(name);
        w.u32(uint32_t(t.parts.size()));
      }
      reply_ok(c, rid, w.out);
      break;
    }
    case 8: {  // JOIN_GROUP
      std::string group = r.str();
      std::string tname = r.str();
      std::string client = r.str();
      if (r.fail) return reply_err(c, rid, "bad join");
      Topic& t = ensure_topic(tname, 1);
      GroupTopic& g = groups_[{group, tname}];
      // Re-joins from existing members (e.g. after observing REBALANCED)
      // must NOT bump the generation, or members would invalidate each
      // other forever.
      if (std::find(g.members.begin(), g.members.end(), client) ==
          g.members.end()) {
        g.members.push_back(client);
        std::sort(g.members.begin(), g.members.end());
        g.rebalance(uint32_t(t.parts.size()));
      } else if (g.generation == 0) {
        g.rebalance(uint32_t(t.parts.size()));
      }
      c.memberships[{group, tname}] = client;
      Writer w;
      w.u32(g.generation);
      auto& mine = g.assigned[client];
      w.u32(uint32_t(mine.size()));
      for (uint32_t p : mine) w.u32(p);
      reply_ok(c, rid, w.out);
      break;
    }
    case 9: {  // LEAVE_GROUP
      std::string group = r.str();
      std::string tname = r.str();
      std::string client = r.str();
      if (r.fail) return reply_err(c, rid, "bad leave");
      auto git = groups_.find({group, tname});
      if (git != groups_.end()) {
        auto& g = git->second;
        g.members.erase(std::remove(g.members.begin(), g.members.end(), client),
                        g.members.end());
        auto tit = topics_.find(tname);
        g.rebalance(tit == topics_.end()
                        ? 0
                        : uint32_t(tit->second.parts.size()));
      }
      c.memberships.erase({group, tname});
      reply_ok(c, rid, "");
      break;
    }
    case 10: {  // PING
      reply_ok(c, rid, "");
      break;
    }
    case 11: {  // OFFSETS
      std::string tname = r.str();
      uint32_t pi = r.u32();
      if (r.fail) return reply_err(c, rid, "bad offsets");
      auto tit = topics_.find(tname);
      if (tit == topics_.end() || pi >= tit->second.parts.size()) {
        Writer w;
        w.u64(0);
        w.u64(0);
        reply_ok(c, rid, w.out);
        break;
      }
      Partition& part = tit->second.parts[pi];
      Writer w;
      w.u64(part.base);
      w.u64(part.end_offset());
      reply_ok(c, rid, w.out);
      break;
    }
    default:
      reply_err(c, rid, "unknown opcode");
  }
}

void Broker::drop_conn(int fd) {
  auto it = conns_.find(fd);
  if (it == conns_.end()) return;
  // Leaving all groups this connection held triggers rebalances so other
  // members pick up the orphaned partitions (parity: session-timeout
  // rebalance in the Kafka group protocol).
  for (auto& [gt, client] : it->second->memberships) {
    auto git = groups_.find(gt);
    if (git == groups_.end()) continue;
    auto& g = git->second;
    g.members.erase(std::remove(g.members.begin(), g.members.end(), client),
                    g.members.end());
    auto tit = topics_.find(gt.second);
    g.rebalance(tit == topics_.end() ? 0
                                     : uint32_t(tit->second.parts.size()));
  }
  for (size_t i = 0; i < parked_.size();) {
    if (parked_[i].conn_fd == fd) {
      parked_.erase(parked_.begin() + i);
    } else {
      i++;
    }
  }
  epoll_ctl(epfd_, EPOLL_CTL_DEL, fd, nullptr);
  close(fd);
  conns_.erase(it);
}

void Broker::flush_out(Conn& c) {
  while (!c.outbuf.empty()) {
    ssize_t n = ::send(c.fd, c.outbuf.data(), c.outbuf.size(), MSG_NOSIGNAL);
    if (n > 0) {
      c.outbuf.erase(0, size_t(n));
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      break;
    } else {
      c.closed = true;
      break;
    }
  }
  update_epoll(c);
}

void Broker::update_epoll(Conn& c) {
  epoll_event ev{};
  ev.data.fd = c.fd;
  ev.events = EPOLLIN | (c.outbuf.empty() ? 0u : uint32_t(EPOLLOUT));
  epoll_ctl(epfd_, EPOLL_CTL_MOD, c.fd, &ev);
}

int Broker::run(const char* host, int port) {
  signal(SIGPIPE, SIG_IGN);
  load_state();

  int lfd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  inet_pton(AF_INET, host, &addr.sin_addr);
  if (bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0) {
    perror("bind");
    return 1;
  }
  socklen_t alen = sizeof addr;
  getsockname(lfd, reinterpret_cast<sockaddr*>(&addr), &alen);
  listen(lfd, 128);

  printf("LISTENING %d\n", ntohs(addr.sin_port));
  fflush(stdout);

  epfd_ = epoll_create1(0);
  epoll_event ev{};
  ev.data.fd = lfd;
  ev.events = EPOLLIN;
  epoll_ctl(epfd_, EPOLL_CTL_ADD, lfd, &ev);

  std::vector<epoll_event> events(256);
  for (;;) {
    uint64_t now = now_ms();
    expire_parked(now);
    int nev = epoll_wait(epfd_, events.data(), int(events.size()),
                         next_parked_timeout(now));
    if (nev < 0) {
      if (errno == EINTR) continue;
      perror("epoll_wait");
      return 1;
    }
    for (int i = 0; i < nev; i++) {
      int fd = events[i].data.fd;
      if (fd == lfd) {
        for (;;) {
          int cfd = accept4(lfd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          auto conn = std::make_unique<Conn>();
          conn->fd = cfd;
          epoll_event cev{};
          cev.data.fd = cfd;
          cev.events = EPOLLIN;
          epoll_ctl(epfd_, EPOLL_CTL_ADD, cfd, &cev);
          conns_[cfd] = std::move(conn);
        }
        continue;
      }
      auto cit = conns_.find(fd);
      if (cit == conns_.end()) continue;
      Conn& c = *cit->second;
      if (events[i].events & (EPOLLHUP | EPOLLERR)) {
        drop_conn(fd);
        continue;
      }
      if (events[i].events & EPOLLOUT) flush_out(c);
      if (events[i].events & EPOLLIN) {
        char buf[65536];
        bool closed = false;
        for (;;) {
          ssize_t n = recv(fd, buf, sizeof buf, 0);
          if (n > 0) {
            c.inbuf.append(buf, size_t(n));
          } else if (n == 0) {
            closed = true;
            break;
          } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
            break;
          } else {
            closed = true;
            break;
          }
        }
        // Drain complete frames.
        while (c.inbuf.size() >= 4) {
          uint32_t len = (uint32_t(uint8_t(c.inbuf[0])) << 24) |
                         (uint32_t(uint8_t(c.inbuf[1])) << 16) |
                         (uint32_t(uint8_t(c.inbuf[2])) << 8) |
                         uint32_t(uint8_t(c.inbuf[3]));
          if (len > (64u << 20)) {
            closed = true;
            break;
          }
          if (c.inbuf.size() < 4 + size_t(len)) break;
          std::string payload = c.inbuf.substr(4, len);
          c.inbuf.erase(0, 4 + size_t(len));
          handle_frame(c, payload);
          if (c.closed) {
            closed = true;
            break;
          }
        }
        if (closed || c.closed) drop_conn(fd);
      }
    }
  }
}

}  // namespace

int main(int argc, char** argv) {
  const char* host = "127.0.0.1";
  int port = 0;
  std::string data_dir;
  for (int i = 1; i < argc; i++) {
    std::string a = argv[i];
    if (a == "--host" && i + 1 < argc) host = argv[++i];
    else if (a == "--port" && i + 1 < argc) port = atoi(argv[++i]);
    else if (a == "--data-dir" && i + 1 < argc) data_dir = argv[++i];
    else {
      fprintf(stderr,
              "usage: tsbroker [--host H] [--port P] [--data-dir DIR]\n");
      return 2;
    }
  }
  Broker broker(data_dir);
  return broker.run(host, port);
}
