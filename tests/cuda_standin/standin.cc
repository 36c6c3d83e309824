// The stand-in's launch (cuda_runtime.h): the blocks of a grid a cluster at
// a time, each thread of the cluster's blocks an OS thread.
#include "cuda_runtime.h"

namespace cusim {

void run(dim3 grid, dim3 block, size_t smem, int cs,
         const std::function<void()>& body) {
  const unsigned nth = block.x * block.y * block.z;
  if (nth % 32) abort();
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x0 = 0; x0 < grid.x; x0 += cs) {
        Cluster cl;
        cl.blocks.resize(cs);
        cl.bar = std::make_unique<std::barrier<>>(cs * nth);
        for (auto& b : cl.blocks) {
          b.smem.assign(smem + 16, (char)0xff);  // NaN bytes
          b.bar = std::make_unique<std::barrier<>>(nth);
          for (unsigned w = 0; w < nth / 32; ++w)
            b.warp_bar.push_back(std::make_unique<std::barrier<>>(32));
          b.ballot.assign(nth, 0);
          b.xch.assign(nth * XCH, 0);
        }
        std::vector<std::thread> th;
        th.reserve(cs * nth);
        for (int r = 0; r < cs; ++r)
          for (unsigned t = 0; t < nth; ++t)
            th.emplace_back([&, r, t] {
              ctx.tid = dim3(t % block.x, t / block.x % block.y,
                             t / (block.x * block.y));
              ctx.lin = (int)t;
              ctx.bid = dim3(x0 + r, y, z);
              ctx.bdim = block;
              ctx.gdim = grid;
              ctx.block = &cl.blocks[r];
              ctx.cluster = &cl;
              ctx.rank = r;
              body();
            });
        for (auto& t : th) t.join();
      }
}

}  // namespace cusim
