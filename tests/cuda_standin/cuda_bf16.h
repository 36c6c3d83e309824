// The stand-in's bf16 (cuda_runtime.h beside this file): what the port's
// headers name, round to nearest even.
#pragma once
#include <cstring>

struct __nv_bfloat16 {
  unsigned short x;
};
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {(unsigned short)(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
