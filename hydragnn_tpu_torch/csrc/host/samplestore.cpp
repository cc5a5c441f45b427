// The port's copy of hydragnn_tpu/native/samplestore.cpp, the code
// unchanged. Packed in-memory sample store with optional POSIX shared-memory
// backing — the host data plane's answer to the reference's DDStore
// (hydragnn/utils/datasets/distdataset.py:72-367, one-sided record get)
// and the AdiosDataset "shmem" read mode (adiosdataset.py:592-642:
// node-local rank 0 loads the dataset, sibling ranks map it read-only).
//
// Layout in one contiguous region:
//   header: int64 magic, int64 n_records, int64 data_bytes
//   offsets: int64[n_records + 1]   (record i = data[off[i] .. off[i+1]))
//   data:    packed record bytes
//
// Writer fills a private buffer (or a shm region) once; readers attach
// by name and fetch records zero-copy. All functions return negative on
// error. Built by hydragnn_tpu_torch/native.py and called through ctypes.

#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {
constexpr int64_t kMagic = 0x48475450553153;  // "HGTPU1S"

struct Header {
  int64_t magic;
  int64_t n_records;
  int64_t data_bytes;
  int64_t n_written;  // records written so far (sequential contract)
};

struct Store {
  void* base = nullptr;
  int64_t total_bytes = 0;
  bool owns_shm = false;
  char name[256] = {0};

  Header* header() const { return (Header*)base; }
  int64_t* offsets() const { return (int64_t*)((char*)base + sizeof(Header)); }
  char* data() const {
    return (char*)base + sizeof(Header) +
           (header()->n_records + 1) * sizeof(int64_t);
  }
};

int64_t region_size(int64_t n_records, int64_t data_bytes) {
  return (int64_t)sizeof(Header) + (n_records + 1) * (int64_t)sizeof(int64_t) +
         data_bytes;
}

}  // namespace

extern "C" {

// Create a store for n_records totalling data_bytes. If shm_name is
// non-NULL, back it with POSIX shared memory (readable by sibling
// processes via hgtpu_store_attach); otherwise use private memory.
void* hgtpu_store_create(int64_t n_records, int64_t data_bytes,
                         const char* shm_name) {
  if (n_records < 0 || data_bytes < 0) return nullptr;
  int64_t total = region_size(n_records, data_bytes);
  Store* st = new Store();
  st->total_bytes = total;
  if (shm_name && shm_name[0]) {
    int fd = shm_open(shm_name, O_CREAT | O_RDWR | O_EXCL, 0600);
    if (fd < 0) {
      delete st;
      return nullptr;
    }
    if (ftruncate(fd, total) != 0) {
      close(fd);
      shm_unlink(shm_name);
      delete st;
      return nullptr;
    }
    st->base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    close(fd);
    if (st->base == MAP_FAILED) {
      shm_unlink(shm_name);
      delete st;
      return nullptr;
    }
    st->owns_shm = true;
    strncpy(st->name, shm_name, sizeof(st->name) - 1);
  } else {
    st->base = mmap(nullptr, total, PROT_READ | PROT_WRITE,
                    MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (st->base == MAP_FAILED) {
      delete st;
      return nullptr;
    }
  }
  Header* h = st->header();
  h->magic = kMagic;
  h->n_records = n_records;
  h->data_bytes = data_bytes;
  h->n_written = 0;
  st->offsets()[0] = 0;
  return st;
}

// Attach (read-only) to a shm store created by another local process.
void* hgtpu_store_attach(const char* shm_name) {
  int fd = shm_open(shm_name, O_RDONLY, 0);
  if (fd < 0) return nullptr;
  struct stat sb;
  if (fstat(fd, &sb) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, sb.st_size, PROT_READ, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  if (((Header*)base)->magic != kMagic) {
    munmap(base, sb.st_size);
    return nullptr;
  }
  Store* st = new Store();
  st->base = base;
  st->total_bytes = sb.st_size;
  st->owns_shm = false;
  return st;
}

// Write record i. Records MUST be written in index order; out-of-order
// writes are rejected (-3) instead of silently corrupting offsets.
int64_t hgtpu_store_put(void* store, int64_t i, const void* bytes,
                        int64_t nbytes) {
  Store* st = (Store*)store;
  if (!st || i < 0 || i >= st->header()->n_records) return -1;
  if (i != st->header()->n_written) return -3;
  int64_t off = st->offsets()[i];
  if (off + nbytes > st->header()->data_bytes) return -2;
  memcpy(st->data() + off, bytes, (size_t)nbytes);
  st->offsets()[i + 1] = off + nbytes;
  st->header()->n_written = i + 1;
  return nbytes;
}

int64_t hgtpu_store_num_records(void* store) {
  Store* st = (Store*)store;
  return st ? st->header()->n_records : -1;
}

int64_t hgtpu_store_record_size(void* store, int64_t i) {
  Store* st = (Store*)store;
  if (!st || i < 0 || i >= st->header()->n_records) return -1;
  return st->offsets()[i + 1] - st->offsets()[i];
}

// Zero-copy pointer to record i (valid while the store is open).
// Never-written records return nullptr instead of empty bytes.
const void* hgtpu_store_get(void* store, int64_t i, int64_t* nbytes) {
  Store* st = (Store*)store;
  if (!st || i < 0 || i >= st->header()->n_written) return nullptr;
  *nbytes = st->offsets()[i + 1] - st->offsets()[i];
  return st->data() + st->offsets()[i];
}

void hgtpu_store_close(void* store) {
  Store* st = (Store*)store;
  if (!st) return;
  if (st->base) munmap(st->base, st->total_bytes);
  if (st->owns_shm && st->name[0]) shm_unlink(st->name);
  delete st;
}

}  // extern "C"
