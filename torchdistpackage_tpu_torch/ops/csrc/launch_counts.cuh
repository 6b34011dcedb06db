// Launches made by one library, by kernel body: a host-side count that
// each launch site bumps (TDP_NOTE) just before its <<<...>>>, read
// through the library's extern "C" tdp_body_launches(name).  Tests and
// chip_smoke.py read it (ops/_build.py body_launches) to prove which
// body a wrapper's call ran.  torch.profiler's kernel list was that proof
// before; on the card, late in a long process, it came back empty for
// half or more of the profile windows (the first window and the last
// alike), so a check built on it fails at random.
#pragma once

#include <string.h>

namespace tdp_launch_counts {

constexpr int kMaxBodies = 32;
static const char* g_names[kMaxBodies];
static unsigned long long g_counts[kMaxBodies];

// ``name`` is a string literal: its pointer outlives the table.
static inline void note(const char* name) {
  for (int i = 0; i < kMaxBodies; ++i) {
    if (g_names[i] == nullptr) g_names[i] = name;
    if (strcmp(g_names[i], name) == 0) {
      ++g_counts[i];
      return;
    }
  }
}

static inline unsigned long long count(const char* name) {
  for (int i = 0; i < kMaxBodies && g_names[i] != nullptr; ++i)
    if (strcmp(g_names[i], name) == 0) return g_counts[i];
  return 0;
}

}  // namespace tdp_launch_counts

#define TDP_NOTE(name) tdp_launch_counts::note(name)

extern "C" unsigned long long tdp_body_launches(const char* name) {
  return tdp_launch_counts::count(name);
}
