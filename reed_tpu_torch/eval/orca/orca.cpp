// Graphlet node-orbit counting (clean-room replacement for the ORCA binary
// used by the reference eval suite at molecule/eval_src/evaluation/stats.py:
// `orca node 4|5 <in> <out>` -> per-node counts of graphlet orbits 0..14
// (node 4) or 0..72 (node 5)).
//
// Design: instead of the original ORCA's system of orbit equations, this
// implementation enumerates every connected induced subgraph of size 3..5
// exactly once with the ESU algorithm (Wernicke 2006) and classifies each
// member node's orbit:
//
//   k=2: orbit 0  = degree
//   k=3: P3 ends  = 1, P3 middle = 2, triangle = 3
//   k=4: P4 ends=4 mids=5; claw leaves=6 center=7; C4=8;
//        paw tail=9 tri=10 tri-hub=11; diamond deg2=12 deg3=13; K4=14
//   k=5: O(1) lookup of the induced 10-bit edge mask in kOrbit5Table
//        (orbit5_table.h, Przulj atlas orbits 15..72; table derived from
//        observed original-ORCA behavior by tools/derive_orbit5_table.py)
//
// Molecular and sampled eval graphs are small and sparse, so enumeration is
// fast and trivially correct. Input/output formats match the reference
// binary: first line "n m", then m undirected edges; stdout prints
// "orbit counts: \n" followed by one line of counts per node.
//
// Build:  g++ -O2 -std=c++17 -o orca orca.cpp
//         g++ -O2 -std=c++17 -shared -fPIC -DORCA_SHARED -o liborca.so orca.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iostream>
#include <set>
#include <string>
#include <vector>

namespace {

struct Graph {
  int n = 0;
  std::vector<std::vector<int>> adj;   // sorted neighbor lists
  std::vector<std::vector<uint8_t>> amat;  // dense adjacency (small graphs)

  bool connected(int u, int v) const { return amat[u][v] != 0; }
};

constexpr int kNumOrbits4 = 15;
constexpr int kNumOrbits5 = 73;

#include "orbit5_table.h"

// Classify orbits of a connected induced 3-subgraph.
void Classify3(const Graph& g, const int s[3], int stride,
               std::vector<int64_t>* counts) {
  int deg[3] = {0, 0, 0};
  int edges = 0;
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (g.connected(s[i], s[j])) {
        ++deg[i];
        ++deg[j];
        ++edges;
      }
  for (int i = 0; i < 3; ++i) {
    int orbit;
    if (edges == 3) {
      orbit = 3;                      // triangle
    } else {                           // P3
      orbit = (deg[i] == 2) ? 2 : 1;   // middle : end
    }
    (*counts)[s[i] * stride + orbit]++;
  }
}

// Classify orbits of a connected induced 4-subgraph.
void Classify4(const Graph& g, const int s[4], int stride,
               std::vector<int64_t>* counts) {
  int deg[4] = {0, 0, 0, 0};
  int edges = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = i + 1; j < 4; ++j)
      if (g.connected(s[i], s[j])) {
        ++deg[i];
        ++deg[j];
        ++edges;
      }
  int degsum = deg[0] + deg[1] + deg[2] + deg[3];
  (void)degsum;
  int maxdeg = std::max(std::max(deg[0], deg[1]), std::max(deg[2], deg[3]));
  for (int i = 0; i < 4; ++i) {
    int orbit = -1;
    switch (edges) {
      case 3:
        if (maxdeg == 3) orbit = (deg[i] == 3) ? 7 : 6;       // claw
        else orbit = (deg[i] == 2) ? 5 : 4;                    // P4
        break;
      case 4:
        if (maxdeg == 2) orbit = 8;                            // C4
        else orbit = (deg[i] == 1) ? 9 : (deg[i] == 2 ? 10 : 11);  // paw
        break;
      case 5:
        orbit = (deg[i] == 2) ? 12 : 13;                       // diamond
        break;
      case 6:
        orbit = 14;                                            // K4
        break;
      default:
        std::abort();  // unreachable: induced connected 4-graphs have >=3
    }
    (*counts)[s[i] * stride + orbit]++;
  }
}

// Classify orbits of a connected induced 5-subgraph via the 10-bit edge
// mask of its member positions (exact by construction of kOrbit5Table).
void Classify5(const Graph& g, const int s[5], int stride,
               std::vector<int64_t>* counts) {
  static constexpr int kPair[10][2] = {{0, 1}, {0, 2}, {0, 3}, {0, 4},
                                       {1, 2}, {1, 3}, {1, 4}, {2, 3},
                                       {2, 4}, {3, 4}};
  int mask = 0;
  for (int b = 0; b < 10; ++b)
    if (g.connected(s[kPair[b][0]], s[kPair[b][1]])) mask |= 1 << b;
  const int8_t* orbits = kOrbit5Table[mask];
  for (int i = 0; i < 5; ++i) {
    if (orbits[i] < 0) std::abort();  // unreachable: ESU yields connected
    (*counts)[s[i] * stride + orbits[i]]++;
  }
}

// ESU: enumerate each connected induced k-subgraph exactly once.
// subgraph: current vertices; extension: candidate vertices (> root, not
// adjacent to earlier subgraph members at the time of insertion).
void ExtendSubgraph(const Graph& g, int root, std::vector<int>* subgraph,
                    std::vector<int>* extension,
                    std::vector<uint8_t>* in_closed, int k, int stride,
                    std::vector<int64_t>* counts) {
  if (static_cast<int>(subgraph->size()) == k) {
    if (k == 3) Classify3(g, subgraph->data(), stride, counts);
    else if (k == 4) Classify4(g, subgraph->data(), stride, counts);
    else Classify5(g, subgraph->data(), stride, counts);
    return;
  }
  // iterate over a snapshot of the extension set
  std::vector<int> ext = *extension;
  while (!ext.empty()) {
    int w = ext.back();
    ext.pop_back();
    // build new extension: ext (remaining) + exclusive neighbors of w
    std::vector<int> next_ext = ext;
    std::vector<int> newly_closed;
    for (int u : g.adj[w]) {
      if (u > root && !(*in_closed)[u]) {
        next_ext.push_back(u);
        (*in_closed)[u] = 1;
        newly_closed.push_back(u);
      }
    }
    subgraph->push_back(w);
    ExtendSubgraph(g, root, subgraph, &next_ext, in_closed, k, stride,
                   counts);
    subgraph->pop_back();
    for (int u : newly_closed) (*in_closed)[u] = 0;
  }
}

// max_k = 4 -> orbits 0..14 (stride 15); max_k = 5 -> 0..72 (stride 73).
void CountOrbits(const Graph& g, int max_k, std::vector<int64_t>* counts) {
  const int stride = max_k == 5 ? kNumOrbits5 : kNumOrbits4;
  counts->assign(static_cast<size_t>(g.n) * stride, 0);
  // orbit 0: degree
  for (int v = 0; v < g.n; ++v)
    (*counts)[v * stride + 0] = static_cast<int64_t>(g.adj[v].size());
  for (int k = 3; k <= max_k; ++k) {
    for (int v = 0; v < g.n; ++v) {
      std::vector<int> subgraph = {v};
      std::vector<int> extension;
      std::vector<uint8_t> in_closed(g.n, 0);
      in_closed[v] = 1;
      for (int u : g.adj[v])
        if (u > v) {
          extension.push_back(u);
          in_closed[u] = 1;
        }
      ExtendSubgraph(g, v, &subgraph, &extension, &in_closed, k, stride,
                     counts);
      // reset handled by scope
    }
  }
}

Graph BuildGraph(int n, const std::vector<std::pair<int, int>>& edges) {
  Graph g;
  g.n = n;
  g.adj.assign(n, {});
  g.amat.assign(n, std::vector<uint8_t>(n, 0));
  for (auto [u, v] : edges) {
    if (u == v || g.amat[u][v]) continue;
    g.amat[u][v] = g.amat[v][u] = 1;
    g.adj[u].push_back(v);
    g.adj[v].push_back(u);
  }
  return g;
}

}  // namespace

extern "C" {

// C API for the Python ctypes binding: edges is a flat [2*m] array.
// out must hold n*15 (max_k=4) or n*73 (max_k=5) int64 values. Returns 0 on
// success.
int orca_count_node_orbits(int max_k, int n, int m, const int* edges,
                           int64_t* out) {
  if (n < 0 || m < 0 || (max_k != 4 && max_k != 5)) return 1;
  std::vector<std::pair<int, int>> e;
  e.reserve(m);
  for (int i = 0; i < m; ++i) {
    int u = edges[2 * i], v = edges[2 * i + 1];
    if (u < 0 || u >= n || v < 0 || v >= n) return 2;
    e.emplace_back(u, v);
  }
  Graph g = BuildGraph(n, e);
  std::vector<int64_t> counts;
  CountOrbits(g, max_k, &counts);
  std::memcpy(out, counts.data(), counts.size() * sizeof(int64_t));
  return 0;
}

int orca_count_node_orbits4(int n, int m, const int* edges, int64_t* out) {
  return orca_count_node_orbits(4, n, m, edges, out);
}

}  // extern "C"

#ifndef ORCA_SHARED
int main(int argc, char** argv) {
  if (argc < 5) {
    std::fprintf(stderr,
                 "usage: %s node 4|5 <input.txt> <output|std>\n", argv[0]);
    return 1;
  }
  const std::string mode = argv[1];
  const int k = std::atoi(argv[2]);
  if (mode != "node" || (k != 4 && k != 5)) {
    std::fprintf(stderr, "only 'node 4' and 'node 5' are supported\n");
    return 1;
  }
  std::ifstream in(argv[3]);
  if (!in) {
    std::fprintf(stderr, "cannot open %s\n", argv[3]);
    return 1;
  }
  int n, m;
  in >> n >> m;
  std::vector<std::pair<int, int>> edges(m);
  for (auto& e : edges) in >> e.first >> e.second;

  Graph g = BuildGraph(n, edges);
  std::vector<int64_t> counts;
  CountOrbits(g, k, &counts);

  const int stride = k == 5 ? kNumOrbits5 : kNumOrbits4;
  std::string out_str = "orbit counts: \n";
  for (int v = 0; v < n; ++v) {
    for (int o = 0; o < stride; ++o) {
      if (o) out_str += ' ';
      out_str += std::to_string(counts[v * stride + o]);
    }
    out_str += '\n';
  }
  std::fputs(out_str.c_str(), stdout);
  const std::string out_arg = argv[4];
  if (out_arg != "std") {
    std::ofstream f(out_arg);
    f << out_str;
  }
  return 0;
}
#endif
