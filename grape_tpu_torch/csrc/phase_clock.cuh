// Optional phase clocks for the cluster kernels, compiled in only with
// -DGRAPE_PHASE_CLOCK (a profile build, see chip_smoke.py): thread 0 of
// block 0 (or the thread named) adds the SM cycles since its previous mark to register slot i,
// and at its end adds the slots to a per-kernel table of 16 counters in
// device memory, so a phase that ends in a barrier includes the wait at
// that barrier.  Without the flag every macro is empty.
#pragma once

#ifdef GRAPE_PHASE_CLOCK
#define GRAPE_CLOCK_TABLE(name) __device__ unsigned long long name[16];
#define GRAPE_CLOCK_START                                              \
    unsigned long long clock_prev_ = clock64();                        \
    unsigned long long clock_acc_[16] = {};
#define GRAPE_CLOCK_MARK(i)                                            \
    {                                                                  \
        const unsigned long long now_ = clock64();                     \
        clock_acc_[i] += now_ - clock_prev_;                           \
        clock_prev_ = now_;                                            \
    }
// called by the measuring thread(s); only block 0 writes
#define GRAPE_CLOCK_FLUSH(table)                                       \
    if (blockIdx.x == 0) {                                             \
        for (int i_ = 0; i_ < 16; ++i_) atomicAdd(&table[i_], clock_acc_[i_]); \
    }
// extern "C" int fn(unsigned long long* host16): copy the table out and
// clear it
#define GRAPE_CLOCK_READER(fn, table)                                  \
    extern "C" int fn(unsigned long long* host) {                     \
        cudaError_t e = cudaMemcpyFromSymbol(host, table,              \
                                             16 * sizeof(long long));  \
        if (e != cudaSuccess) return (int)e;                           \
        unsigned long long zero[16] = {};                              \
        return (int)cudaMemcpyToSymbol(table, zero, sizeof(zero));     \
    }
#else
#define GRAPE_CLOCK_TABLE(name)
#define GRAPE_CLOCK_START
#define GRAPE_CLOCK_MARK(i) \
    {}
#define GRAPE_CLOCK_FLUSH(table) \
    {}
#define GRAPE_CLOCK_READER(fn, table)
#endif
