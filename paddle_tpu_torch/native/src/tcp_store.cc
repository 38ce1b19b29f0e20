// TCPStore: rendezvous key-value store for multi-host bootstrap.
//
// Reference capability: `paddle/phi/core/distributed/store/tcp_store.h:121`
// (TCPStore : Store — master on rank 0, blocking get/wait, atomic add)
// and `tcp_utils.cc`. The serving control plane needs no process groups,
// only a small, reliable bootstrap/rendezvous store (the rpc mailboxes
// ride it): set/get/add/wait/delete over TCP with blocking semantics
// served by a thread-per-connection master.
//
// Wire protocol (little-endian):
//   request:  [u8 cmd][u32 klen][key][u64 vlen][value]
//             cmd: 1=SET 2=GET 3=ADD 4=WAIT 5=DEL 6=NUMKEYS
//             GET/WAIT: vlen==8, value = i64 timeout_ms
//             ADD:      vlen==8, value = i64 delta
//   response: [u8 status][u64 vlen][value]   status: 1=ok 0=timeout/miss

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <netdb.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

enum Cmd : uint8_t { kSet = 1, kGet = 2, kAdd = 3, kWait = 4, kDel = 5,
                     kNumKeys = 6 };

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stopping{false};
  std::thread accept_thread;
  // detached handler threads are tracked by fd + active count so stop()
  // can interrupt their blocking recv (shutdown) and wait for drain
  std::mutex conn_mu;
  std::condition_variable conn_cv;
  std::unordered_set<int> open_fds;
  int active = 0;

  std::mutex mu;
  std::condition_variable cv;  // signalled on every SET/ADD/DEL
  std::unordered_map<std::string, std::vector<uint8_t>> data;

  ~Server() { stop(); }

  void stop() {
    bool expected = false;
    if (!stopping.compare_exchange_strong(expected, true)) return;
    if (listen_fd >= 0) {
      ::shutdown(listen_fd, SHUT_RDWR);
      ::close(listen_fd);
    }
    {
      // Hold mu so the stopping publish is ordered against handlers'
      // predicate checks: notify without it can slip between a waiter
      // evaluating the predicate and parking, losing the wakeup.
      std::lock_guard<std::mutex> lk(mu);
      cv.notify_all();  // release handlers parked in blocking GET/WAIT
    }
    {
      std::lock_guard<std::mutex> lk(conn_mu);
      for (int fd : open_fds) ::shutdown(fd, SHUT_RDWR);
    }
    if (accept_thread.joinable()) accept_thread.join();
    std::unique_lock<std::mutex> lk(conn_mu);
    conn_cv.wait(lk, [this] { return active == 0; });
  }

  void conn_main(int fd) {
    handle_conn(fd);
    std::lock_guard<std::mutex> lk(conn_mu);
    open_fds.erase(fd);
    ::close(fd);  // after erase: stop() can no longer shutdown this fd
    --active;
    conn_cv.notify_all();
  }

  void handle_conn(int fd) {
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    for (;;) {
      uint8_t cmd;
      uint32_t klen;
      uint64_t vlen;
      if (!recv_all(fd, &cmd, 1) || !recv_all(fd, &klen, 4)) break;
      if (klen > (1u << 20)) break;
      std::string key(klen, '\0');
      if (klen && !recv_all(fd, &key[0], klen)) break;
      if (!recv_all(fd, &vlen, 8)) break;
      if (vlen > (1ull << 32)) break;
      std::vector<uint8_t> val(vlen);
      if (vlen && !recv_all(fd, val.data(), vlen)) break;

      uint8_t status = 1;
      std::vector<uint8_t> reply;
      switch (cmd) {
        case kSet: {
          std::lock_guard<std::mutex> lk(mu);
          data[key] = std::move(val);
          cv.notify_all();
          break;
        }
        case kAdd: {
          int64_t delta = 0;
          if (val.size() == 8) std::memcpy(&delta, val.data(), 8);
          std::lock_guard<std::mutex> lk(mu);
          int64_t cur = 0;
          auto it = data.find(key);
          if (it != data.end() && it->second.size() == 8)
            std::memcpy(&cur, it->second.data(), 8);
          cur += delta;
          std::vector<uint8_t> stored(8);
          std::memcpy(stored.data(), &cur, 8);
          data[key] = stored;
          reply = stored;
          cv.notify_all();
          break;
        }
        case kGet:
        case kWait: {
          int64_t timeout_ms = -1;
          if (val.size() == 8) std::memcpy(&timeout_ms, val.data(), 8);
          std::unique_lock<std::mutex> lk(mu);
          auto ready = [&] {
            return stopping.load() || data.count(key) != 0;
          };
          if (timeout_ms < 0) {
            cv.wait(lk, ready);
          } else {
            cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), ready);
          }
          auto it = data.find(key);
          if (it == data.end()) {
            status = 0;  // timeout (or server stopping)
          } else if (cmd == kGet) {
            reply = it->second;
          }
          break;
        }
        case kDel: {
          std::lock_guard<std::mutex> lk(mu);
          status = data.erase(key) ? 1 : 0;
          cv.notify_all();
          break;
        }
        case kNumKeys: {
          std::lock_guard<std::mutex> lk(mu);
          int64_t n = static_cast<int64_t>(data.size());
          reply.resize(8);
          std::memcpy(reply.data(), &n, 8);
          break;
        }
        default:
          status = 0;
      }
      uint64_t rlen = reply.size();
      if (!send_all(fd, &status, 1) || !send_all(fd, &rlen, 8) ||
          (rlen && !send_all(fd, reply.data(), rlen)))
        break;
    }
  }

  bool start(int want_port) {
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    ::setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(want_port));
    if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) != 0 ||
        ::listen(listen_fd, 128) != 0) {
      ::close(listen_fd);
      listen_fd = -1;
      return false;
    }
    socklen_t alen = sizeof(addr);
    ::getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
    port = ntohs(addr.sin_port);
    accept_thread = std::thread([this] {
      for (;;) {
        int fd = ::accept(listen_fd, nullptr, nullptr);
        if (fd < 0) {
          if (stopping.load()) return;
          continue;
        }
        {
          std::lock_guard<std::mutex> lk(conn_mu);
          if (stopping.load()) {
            ::close(fd);
            continue;
          }
          open_fds.insert(fd);
          ++active;
        }
        std::thread([this, fd] { conn_main(fd); }).detach();
      }
    });
    return true;
  }
};

struct Client {
  int fd = -1;
  std::mutex mu;  // one in-flight request per connection

  ~Client() {
    if (fd >= 0) ::close(fd);
  }

  // Single request-response round trip; returns status (or -1 on I/O
  // error) and fills *out.
  int request(uint8_t cmd, const char* key, const void* val, uint64_t vlen,
              std::vector<uint8_t>* out) {
    std::lock_guard<std::mutex> lk(mu);
    uint32_t klen = static_cast<uint32_t>(std::strlen(key));
    if (!send_all(fd, &cmd, 1) || !send_all(fd, &klen, 4) ||
        !send_all(fd, key, klen) || !send_all(fd, &vlen, 8) ||
        (vlen && !send_all(fd, val, vlen)))
      return -1;
    uint8_t status;
    uint64_t rlen;
    if (!recv_all(fd, &status, 1) || !recv_all(fd, &rlen, 8)) return -1;
    out->resize(rlen);
    if (rlen && !recv_all(fd, out->data(), rlen)) return -1;
    return status;
  }
};

}  // namespace

extern "C" {

void* pts_store_server_start(int port) {
  auto* s = new Server();
  if (!s->start(port)) {
    delete s;
    return nullptr;
  }
  return s;
}

int pts_store_server_port(void* h) { return static_cast<Server*>(h)->port; }

void pts_store_server_stop(void* h) { delete static_cast<Server*>(h); }

void* pts_store_connect(const char* host, int port, int timeout_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  addrinfo hints{};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  std::string port_str = std::to_string(port);
  for (;;) {
    addrinfo* res = nullptr;  // re-resolve per retry: DNS may lag boot
    if (::getaddrinfo(host, port_str.c_str(), &hints, &res) == 0) {
      for (addrinfo* ai = res; ai; ai = ai->ai_next) {
        int fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
        if (fd < 0) continue;
        if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) {
          int one = 1;
          ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          ::freeaddrinfo(res);
          auto* c = new Client();
          c->fd = fd;
          return c;
        }
        ::close(fd);
      }
      ::freeaddrinfo(res);
    }
    if (std::chrono::steady_clock::now() >= deadline) return nullptr;
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
}

void pts_store_disconnect(void* h) { delete static_cast<Client*>(h); }

int pts_store_set(void* h, const char* key, const uint8_t* val,
                  uint64_t len) {
  std::vector<uint8_t> out;
  return static_cast<Client*>(h)->request(kSet, key, val, len, &out) == 1
             ? 0
             : -1;
}

// Returns a malloc'd buffer the caller frees with pts_buf_free; *len set
// to the value size. nullptr on timeout / error.
uint8_t* pts_store_get(void* h, const char* key, uint64_t* len,
                       int64_t timeout_ms) {
  std::vector<uint8_t> out;
  int st = static_cast<Client*>(h)->request(kGet, key, &timeout_ms, 8, &out);
  if (st != 1) return nullptr;
  auto* buf = static_cast<uint8_t*>(std::malloc(out.size() ? out.size() : 1));
  if (!out.empty()) std::memcpy(buf, out.data(), out.size());
  *len = out.size();
  return buf;
}

int64_t pts_store_add(void* h, const char* key, int64_t delta) {
  std::vector<uint8_t> out;
  int st = static_cast<Client*>(h)->request(kAdd, key, &delta, 8, &out);
  if (st != 1 || out.size() != 8) return INT64_MIN;
  int64_t v;
  std::memcpy(&v, out.data(), 8);
  return v;
}

int pts_store_wait(void* h, const char* key, int64_t timeout_ms) {
  std::vector<uint8_t> out;
  int st = static_cast<Client*>(h)->request(kWait, key, &timeout_ms, 8, &out);
  return st == 1 ? 0 : -1;
}

int pts_store_del(void* h, const char* key) {
  std::vector<uint8_t> out;
  return static_cast<Client*>(h)->request(kDel, key, nullptr, 0, &out) == 1
             ? 0
             : -1;
}

int64_t pts_store_numkeys(void* h) {
  std::vector<uint8_t> out;
  int st = static_cast<Client*>(h)->request(kNumKeys, "", nullptr, 0, &out);
  if (st != 1 || out.size() != 8) return -1;
  int64_t v;
  std::memcpy(&v, out.data(), 8);
  return v;
}

void pts_buf_free(uint8_t* p) { std::free(p); }

}  // extern "C"
