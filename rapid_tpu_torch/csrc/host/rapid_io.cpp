// Native framed-TCP reactor: one epoll thread replaces thread-per-connection.
//
// The runtime-IO analogue of the reference's Netty event-loop group
// (SharedResources.java:48-67 lazily creates one NIO event-loop shared by
// every channel; NettyClientServer.java:65 builds both transport halves on
// it). The Python transport (rapid_tpu_torch/messaging/tcp.py) spends one blocking
// reader thread per accepted connection; this reactor multiplexes every
// connection of a server onto a single epoll loop in native code, handing
// complete frames to Python through a poll()-style event queue.
//
// Wire format: identical to rapid_tpu_torch.messaging.codec -- a big-endian u32
// length prefix followed by the payload (the request-no/type-tag/msgpack
// envelope is parsed in Python; the reactor only frames bytes).
//
// Contract (all functions exported with C linkage, driven via ctypes):
//   rapid_io_server_create(host, port)        -> handle >= 1, or -errno
//   rapid_io_server_port(h)                   -> bound port (after create)
//   rapid_io_server_poll(h, &conn, buf, cap, &len, timeout_ms)
//       -> 0 none, 1 frame (copied to buf; if it exceeds cap, len is set,
//          the event stays queued, nothing is copied -- retry with a bigger
//          buffer), 2 connection closed, -1 server shut down
//   rapid_io_server_send(h, conn, data, len)  -> 0 ok, -1 connection gone
//   rapid_io_server_shutdown(h)               -> idempotent; wakes pollers
//
// Threading: create/shutdown from any thread; poll from any number of
// threads (events are consumed exactly once); send from any thread and
// never blocks -- frames are serialized per connection, and bytes the
// socket won't take are queued (capped) for the reactor's EPOLLOUT flush.

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t kMaxFrame = 64ull * 1024 * 1024;  // parity with tcp.py

struct Conn {
  int fd = -1;
  int64_t id = 0;
  std::vector<uint8_t> rbuf;
  // write side (guarded by write_mu): sends that would block are queued and
  // flushed by the reactor on EPOLLOUT, so rapid_io_server_send never stalls
  // the calling thread on a slow peer
  std::mutex write_mu;
  std::deque<std::vector<uint8_t>> wqueue;
  size_t woff = 0;      // bytes of wqueue.front() already written
  size_t wbytes = 0;    // total queued bytes (capped)
  bool want_write = false;  // EPOLLOUT currently armed
  std::atomic<bool> open{true};
};

constexpr size_t kMaxQueuedWrite = 64ull * 1024 * 1024;

// epoll_event.data.u64 tags: connection events carry the conn id (>= 1), so
// a stale event left in an epoll_wait batch after its connection was closed
// -- and whose fd number may already be reused by an accept later in the
// same batch -- resolves to a dead id and is dropped, instead of being
// misattributed to the new connection.
constexpr uint64_t kListenTag = 0;
constexpr uint64_t kWakeTag = ~0ull;

struct Event {
  int type;  // 1 = frame, 2 = closed
  int64_t conn_id;
  std::vector<uint8_t> frame;
};

struct Server {
  int listen_fd = -1;
  int epfd = -1;
  int wake_pipe[2] = {-1, -1};
  int port = 0;
  std::thread loop;
  std::atomic<bool> running{true};

  std::mutex mu;  // conns + events + cv
  std::condition_variable cv;
  std::unordered_map<int64_t, std::shared_ptr<Conn>> conns;
  std::deque<Event> events;
  int64_t next_conn_id = 1;
};

std::mutex g_mu;
std::unordered_map<int64_t, std::shared_ptr<Server>> g_servers;
int64_t g_next_handle = 1;

std::shared_ptr<Server> lookup(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_servers.find(handle);
  return it == g_servers.end() ? nullptr : it->second;
}

int set_nonblocking(int fd) {
  int flags = fcntl(fd, F_GETFL, 0);
  if (flags < 0) return -1;
  return fcntl(fd, F_SETFL, flags | O_NONBLOCK);
}

void arm_writable(Server& srv, Conn& conn, bool on) {
  // caller holds conn.write_mu
  if (conn.want_write == on) return;
  conn.want_write = on;
  epoll_event ev{};
  ev.events = EPOLLIN | (on ? EPOLLOUT : 0u);
  ev.data.u64 = static_cast<uint64_t>(conn.id);
  epoll_ctl(srv.epfd, EPOLL_CTL_MOD, conn.fd, &ev);
}

// Write as much of the queue as the socket accepts; returns false when the
// connection errored and must be torn down. Caller holds conn.write_mu.
bool flush_wqueue(Server& srv, Conn& conn) {
  while (!conn.wqueue.empty()) {
    auto& front = conn.wqueue.front();
    ssize_t sent = send(conn.fd, front.data() + conn.woff,
                        front.size() - conn.woff, MSG_NOSIGNAL);
    if (sent > 0) {
      conn.woff += static_cast<size_t>(sent);
      conn.wbytes -= static_cast<size_t>(sent);
      if (conn.woff == front.size()) {
        conn.wqueue.pop_front();
        conn.woff = 0;
      }
    } else if (sent < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      arm_writable(srv, conn, true);
      return true;
    } else if (sent < 0 && errno == EINTR) {
      continue;
    } else {
      return false;
    }
  }
  arm_writable(srv, conn, false);
  return true;
}

void enqueue_event(Server& srv, Event ev) {
  {
    std::lock_guard<std::mutex> lk(srv.mu);
    srv.events.push_back(std::move(ev));
  }
  srv.cv.notify_one();
}

// Split rbuf into complete frames; returns false on a protocol violation
// (oversized frame) -- the connection is killed like tcp.py's ValueError.
bool drain_frames(Server& srv, Conn& conn) {
  size_t off = 0;
  while (conn.rbuf.size() - off >= 4) {
    uint32_t be;
    memcpy(&be, conn.rbuf.data() + off, 4);
    uint64_t need = ntohl(be);
    if (need > kMaxFrame) return false;
    if (conn.rbuf.size() - off - 4 < need) break;
    Event ev;
    ev.type = 1;
    ev.conn_id = conn.id;
    ev.frame.assign(conn.rbuf.begin() + off + 4,
                    conn.rbuf.begin() + off + 4 + need);
    enqueue_event(srv, std::move(ev));
    off += 4 + need;
  }
  if (off > 0) conn.rbuf.erase(conn.rbuf.begin(), conn.rbuf.begin() + off);
  return true;
}

void close_conn(Server& srv, int64_t conn_id) {
  std::shared_ptr<Conn> conn;
  {
    std::lock_guard<std::mutex> lk(srv.mu);
    auto it = srv.conns.find(conn_id);
    if (it == srv.conns.end()) return;  // already closed (e.g. stale event)
    conn = it->second;
    srv.conns.erase(it);
  }
  conn->open.store(false);
  // FIN before taking write_mu, then close under it: concurrent senders
  // fail fast on the shut-down socket and can never write into a reused
  // fd number
  shutdown(conn->fd, SHUT_RDWR);
  std::lock_guard<std::mutex> wl(conn->write_mu);
  epoll_ctl(srv.epfd, EPOLL_CTL_DEL, conn->fd, nullptr);
  close(conn->fd);
  Event ev;
  ev.type = 2;
  ev.conn_id = conn->id;
  enqueue_event(srv, std::move(ev));
}

void reactor_loop(std::shared_ptr<Server> srv) {
  epoll_event evs[64];
  std::vector<uint8_t> chunk(256 * 1024);
  while (srv->running.load()) {
    int n = epoll_wait(srv->epfd, evs, 64, 500);
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    for (int i = 0; i < n && srv->running.load(); ++i) {
      uint64_t tag = evs[i].data.u64;
      if (tag == kWakeTag) {
        uint8_t b;
        while (read(srv->wake_pipe[0], &b, 1) > 0) {
        }
        continue;
      }
      if (tag == kListenTag) {
        for (;;) {
          int cfd = accept(srv->listen_fd, nullptr, nullptr);
          if (cfd < 0) break;
          if (set_nonblocking(cfd) < 0) {
            close(cfd);
            continue;
          }
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          auto conn = std::make_shared<Conn>();
          conn->fd = cfd;
          {
            std::lock_guard<std::mutex> lk(srv->mu);
            conn->id = srv->next_conn_id++;
            srv->conns[conn->id] = conn;
          }
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.u64 = static_cast<uint64_t>(conn->id);
          if (epoll_ctl(srv->epfd, EPOLL_CTL_ADD, cfd, &ev) < 0) {
            close_conn(*srv, conn->id);
          }
        }
        continue;
      }
      // connection readable (or errored); a dead id means the connection was
      // closed earlier in this batch -- drop the stale event (its fd number
      // may already belong to a newly accepted connection)
      std::shared_ptr<Conn> conn;
      {
        std::lock_guard<std::mutex> lk(srv->mu);
        auto it = srv->conns.find(static_cast<int64_t>(tag));
        if (it != srv->conns.end()) conn = it->second;
      }
      if (!conn) continue;
      int fd = conn->fd;
      bool dead = (evs[i].events & (EPOLLHUP | EPOLLERR)) != 0;
      if (!dead && (evs[i].events & EPOLLOUT)) {
        std::lock_guard<std::mutex> wl(conn->write_mu);
        if (!flush_wqueue(*srv, *conn)) dead = true;
      }
      if (!(evs[i].events & EPOLLIN) && !dead) continue;
      while (!dead) {
        ssize_t got = read(fd, chunk.data(), chunk.size());
        if (got > 0) {
          conn->rbuf.insert(conn->rbuf.end(), chunk.data(),
                            chunk.data() + got);
          if (!drain_frames(*srv, *conn)) dead = true;
          if (static_cast<size_t>(got) < chunk.size()) break;
        } else if (got == 0) {
          dead = true;  // peer sent FIN
        } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
          break;
        } else if (errno == EINTR) {
          continue;
        } else {
          dead = true;
        }
      }
      if (dead) close_conn(*srv, conn->id);
    }
  }
}

}  // namespace

extern "C" {

int64_t rapid_io_server_create(const char* host, int port) {
  auto srv = std::make_shared<Server>();
  srv->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (srv->listen_fd < 0) return -errno;
  int one = 1;
  setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(srv->listen_fd);
    return -EINVAL;
  }
  if (bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
          0 ||
      listen(srv->listen_fd, 128) < 0 || set_nonblocking(srv->listen_fd) < 0) {
    int err = errno;
    close(srv->listen_fd);
    return -err;
  }
  socklen_t alen = sizeof(addr);
  getsockname(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  srv->port = ntohs(addr.sin_port);

  if (pipe(srv->wake_pipe) < 0 ||
      set_nonblocking(srv->wake_pipe[0]) < 0 ||
      (srv->epfd = epoll_create1(0)) < 0) {
    int err = errno;
    close(srv->listen_fd);
    if (srv->wake_pipe[0] >= 0) close(srv->wake_pipe[0]);
    if (srv->wake_pipe[1] >= 0) close(srv->wake_pipe[1]);
    return -err;
  }
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.u64 = kListenTag;
  epoll_ctl(srv->epfd, EPOLL_CTL_ADD, srv->listen_fd, &ev);
  ev.data.u64 = kWakeTag;
  epoll_ctl(srv->epfd, EPOLL_CTL_ADD, srv->wake_pipe[0], &ev);

  srv->loop = std::thread(reactor_loop, srv);

  std::lock_guard<std::mutex> lk(g_mu);
  int64_t handle = g_next_handle++;
  g_servers[handle] = srv;
  return handle;
}

int rapid_io_server_port(int64_t handle) {
  auto srv = lookup(handle);
  return srv ? srv->port : -1;
}

int rapid_io_server_poll(int64_t handle, int64_t* conn_id, uint8_t* buf,
                         int64_t buf_cap, int64_t* len, int timeout_ms) {
  auto srv = lookup(handle);
  if (!srv) return -1;
  std::unique_lock<std::mutex> lk(srv->mu);
  if (!srv->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [&] {
        return !srv->events.empty() || !srv->running.load();
      })) {
    return 0;  // timeout
  }
  if (srv->events.empty()) return srv->running.load() ? 0 : -1;
  Event& ev = srv->events.front();
  *conn_id = ev.conn_id;
  if (ev.type == 1) {
    *len = static_cast<int64_t>(ev.frame.size());
    if (*len > buf_cap) return 1;  // stays queued; caller grows the buffer
    memcpy(buf, ev.frame.data(), ev.frame.size());
  } else {
    *len = 0;
  }
  int type = ev.type;
  srv->events.pop_front();
  return type;
}

int rapid_io_server_send(int64_t handle, int64_t conn_id, const uint8_t* data,
                         int64_t len) {
  auto srv = lookup(handle);
  if (!srv || len < 0 || static_cast<uint64_t>(len) > kMaxFrame) return -1;
  std::shared_ptr<Conn> conn;
  {
    std::lock_guard<std::mutex> lk(srv->mu);
    auto it = srv->conns.find(conn_id);
    if (it == srv->conns.end()) return -1;
    conn = it->second;
  }
  uint32_t be = htonl(static_cast<uint32_t>(len));
  std::vector<uint8_t> out(4 + len);
  memcpy(out.data(), &be, 4);
  if (len > 0) memcpy(out.data() + 4, data, len);

  // Never blocks: bytes the socket won't take are queued for the reactor's
  // EPOLLOUT flush, so one stalled peer cannot head-of-line-block the
  // caller (the reply path runs on the dispatcher thread).
  std::lock_guard<std::mutex> wl(conn->write_mu);
  if (!conn->open.load()) return -1;
  if (conn->wbytes + out.size() > kMaxQueuedWrite) return -1;  // peer stalled
  if (conn->wqueue.empty()) {
    size_t off = 0;
    while (off < out.size()) {
      ssize_t sent =
          send(conn->fd, out.data() + off, out.size() - off, MSG_NOSIGNAL);
      if (sent > 0) {
        off += static_cast<size_t>(sent);
      } else if (sent < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        break;
      } else if (sent < 0 && errno == EINTR) {
        continue;
      } else {
        return -1;
      }
    }
    if (off == out.size()) return 0;
    out.erase(out.begin(), out.begin() + off);
  }
  conn->wbytes += out.size();
  conn->wqueue.push_back(std::move(out));
  arm_writable(*srv, *conn, true);
  return 0;
}

void rapid_io_server_shutdown(int64_t handle) {
  std::shared_ptr<Server> srv;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_servers.find(handle);
    if (it == g_servers.end()) return;
    srv = it->second;
    g_servers.erase(it);
  }
  srv->running.store(false);
  uint8_t b = 1;
  ssize_t ignored = write(srv->wake_pipe[1], &b, 1);
  (void)ignored;
  srv->cv.notify_all();
  if (srv->loop.joinable()) srv->loop.join();

  std::vector<std::shared_ptr<Conn>> conns;
  {
    std::lock_guard<std::mutex> lk(srv->mu);
    for (auto& kv : srv->conns) conns.push_back(kv.second);
    srv->conns.clear();
  }
  for (auto& conn : conns) {
    // same exclusion dance as close_conn: flip open and FIN first (peers
    // blocked in recv() sense liveness by EOF), then close under write_mu
    // so no in-flight send() can write into a reused fd number
    conn->open.store(false);
    shutdown(conn->fd, SHUT_RDWR);
    std::lock_guard<std::mutex> wl(conn->write_mu);
    close(conn->fd);
  }
  shutdown(srv->listen_fd, SHUT_RDWR);
  close(srv->listen_fd);
  close(srv->epfd);
  close(srv->wake_pipe[0]);
  close(srv->wake_pipe[1]);
  srv->cv.notify_all();
}

}  // extern "C"
