// Native SMILES featurizer: the port's host-side data-loading path.
//
// C++ implementation of the port's Python chemistry layer
// (chem/smiles.py + chem/featurize.py + the Morgan fingerprint of
// chem/fingerprints.py), exposed through a C ABI consumed via ctypes
// (chem/native.py). Its outputs are BIT-IDENTICAL to the Python
// implementation (tests/test_torch_native.py): same parse/perception rules
// (ring perception via bridge detection, Kekule aromatization, Daylight
// implicit-H model, hybridization), same 35-dim one-hot layout (reference
// train.py:19-55 semantics), same edge ordering (sorted COO, both
// directions), and the same CRC32 integer-stream Morgan hashing.
//
// Thread-safe: every namespace-scope table is const and filled before any
// call (the CRC table at compile time), so request threads of the HTTP
// server may featurize at once (ctypes releases the GIL during a call).
// The batch call splits its molecules over worker threads of its own and
// joins them all before it returns: no thread outlives a call.
//
// Build (chem/native.py does this at first use, into csrc/build/):
//   g++ -O3 -shared -fPIC -std=c++17 -pthread featurizer.cpp -o <name>.so

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <map>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- CRC32
// The reflected CRC-32 table (polynomial 0xEDB88320), computed by the
// compiler: no first-call initialisation that two threads could race on.
struct CrcTable {
  uint32_t v[256];
};

constexpr CrcTable make_crc_table() {
  CrcTable t{};
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    t.v[i] = c;
  }
  return t;
}

constexpr CrcTable kCrcTable = make_crc_table();
static_assert(kCrcTable.v[1] == 0x77073096u, "CRC-32 table");
static_assert(kCrcTable.v[255] == 0x2D02EF8Du, "CRC-32 table");

uint32_t crc32_bytes(const uint8_t* data, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    c = kCrcTable.v[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t crc_ints(uint32_t tag, const std::vector<uint32_t>& ints) {
  std::vector<uint8_t> buf;
  buf.reserve(4 * (ints.size() + 1));
  auto push = [&buf](uint32_t v) {
    buf.push_back(v & 0xFF);
    buf.push_back((v >> 8) & 0xFF);
    buf.push_back((v >> 16) & 0xFF);
    buf.push_back((v >> 24) & 0xFF);
  };
  push(tag);
  for (uint32_t v : ints) push(v);
  return crc32_bytes(buf.data(), buf.size());
}

// ------------------------------------------------------------- chemistry
const std::map<std::string, int> kAtomicNumbers = {
    {"H", 1},  {"He", 2},  {"Li", 3},  {"Be", 4},  {"B", 5},   {"C", 6},
    {"N", 7},  {"O", 8},   {"F", 9},   {"Ne", 10}, {"Na", 11}, {"Mg", 12},
    {"Al", 13},{"Si", 14}, {"P", 15},  {"S", 16},  {"Cl", 17}, {"Ar", 18},
    {"K", 19}, {"Ca", 20}, {"Sc", 21}, {"Ti", 22}, {"V", 23},  {"Cr", 24},
    {"Mn", 25},{"Fe", 26}, {"Co", 27}, {"Ni", 28}, {"Cu", 29}, {"Zn", 30},
    {"Ga", 31},{"Ge", 32}, {"As", 33}, {"Se", 34}, {"Br", 35}, {"Kr", 36},
    {"Rb", 37},{"Sr", 38}, {"Y", 39},  {"Zr", 40}, {"Nb", 41}, {"Mo", 42},
    {"Tc", 43},{"Ru", 44}, {"Rh", 45}, {"Pd", 46}, {"Ag", 47}, {"Cd", 48},
    {"In", 49},{"Sn", 50}, {"Sb", 51}, {"Te", 52}, {"I", 53},  {"Xe", 54},
    {"Cs", 55},{"Ba", 56}, {"Pt", 78}, {"Au", 79}, {"Hg", 80}, {"Tl", 81},
    {"Pb", 82},{"Bi", 83},
};

const std::map<std::string, std::vector<int>> kValences = {
    {"B", {3}}, {"C", {4}}, {"N", {3, 5}}, {"O", {2}}, {"P", {3, 5}},
    {"S", {2, 4, 6}}, {"F", {1}}, {"Cl", {1}}, {"Br", {1}}, {"I", {1}},
};

const std::set<std::string> kOrganic = {"B", "C", "N", "O", "P",
                                        "S", "F", "Cl", "Br", "I"};

// Outer-shell electron counts for the steric-number hybridization model
// (mirrors _OUTER_ELECS in chem/smiles.py; transition metals absent
// deliberately -> no lone-pair term).
const std::map<std::string, int> kOuterElecs = {
    {"H", 1},  {"He", 2}, {"Li", 1}, {"Be", 2}, {"B", 3},  {"C", 4},
    {"N", 5},  {"O", 6},  {"F", 7},  {"Ne", 8}, {"Na", 1}, {"Mg", 2},
    {"Al", 3}, {"Si", 4}, {"P", 5},  {"S", 6},  {"Cl", 7}, {"Ar", 8},
    {"K", 1},  {"Ca", 2}, {"Ga", 3}, {"Ge", 4}, {"As", 5}, {"Se", 6},
    {"Br", 7}, {"Kr", 8}, {"Rb", 1}, {"Sr", 2}, {"In", 3}, {"Sn", 4},
    {"Sb", 5}, {"Te", 6}, {"I", 7},  {"Xe", 8}, {"Cs", 1}, {"Ba", 2},
    {"Tl", 3}, {"Pb", 4}, {"Bi", 5},
};

enum Hyb { HYB_UNSPEC = 0, HYB_S, HYB_SP, HYB_SP2, HYB_SP3,
           HYB_SP3D, HYB_SP3D2 };

struct Atom {
  std::string symbol;
  bool aromatic = false;
  int charge = 0;
  int isotope = 0;
  int explicit_hs = 0;
  bool is_bracket = false;
  // perception
  int implicit_hs = 0;
  bool in_ring = false;
  bool lp_donor = false;  // aromatized by donating a lone pair
  Hyb hyb = HYB_UNSPEC;
  std::vector<int> neighbors;
  std::vector<int> bond_idxs;
  int degree() const { return (int)neighbors.size(); }
  int total_hs() const { return implicit_hs + std::max(explicit_hs, 0); }
};

struct Bond {
  int a1, a2;
  double order = 1.0;
  bool aromatic = false;
  bool in_ring = false;
  int other(int i) const { return i == a1 ? a2 : a1; }
};

struct Mol {
  std::vector<Atom> atoms;
  std::vector<Bond> bonds;
};

// ---------------------------------------------------------------- parser
struct ParseState {
  const std::string& s;
  size_t i = 0;
  bool ok = true;
};

bool parse_bracket(const std::string& s, size_t& i, Atom& atom) {
  size_t end = s.find(']', i);
  if (end == std::string::npos) return false;
  std::string body = s.substr(i + 1, end - i - 1);
  size_t j = 0;
  int isotope = 0;
  while (j < body.size() && isdigit((unsigned char)body[j]))
    isotope = isotope * 10 + (body[j++] - '0');
  std::string sym;
  bool aromatic = false;
  if (j < body.size()) {
    std::string two = body.substr(j, 2);
    if (two == "se" || two == "as" || two == "te") {
      sym = two; j += 2; aromatic = true;
    } else if (isupper((unsigned char)body[j])) {
      if (j + 1 < body.size() && islower((unsigned char)body[j + 1]) &&
          kAtomicNumbers.count(body.substr(j, 2))) {
        sym = body.substr(j, 2); j += 2;
      } else {
        sym = body.substr(j, 1); j += 1;
      }
    } else if (islower((unsigned char)body[j])) {
      sym = body.substr(j, 1); j += 1; aromatic = true;
    } else if (body[j] == '*') {
      sym = "*"; j += 1;
    }
  }
  if (sym.empty()) return false;
  if (aromatic) sym[0] = (char)toupper((unsigned char)sym[0]);

  while (j < body.size() && body[j] == '@') j++;
  if (j + 1 < body.size() &&
      (body.substr(j, 2) == "TH" || body.substr(j, 2) == "AL" ||
       body.substr(j, 2) == "SP"))
    j += 2;

  int hs = 0;
  if (j < body.size() && body[j] == 'H') {
    j++; hs = 1;
    std::string num;
    while (j < body.size() && isdigit((unsigned char)body[j]))
      num += body[j++];
    if (!num.empty()) hs = std::stoi(num);
  }

  int charge = 0;
  while (j < body.size() && (body[j] == '+' || body[j] == '-')) {
    int sign = body[j] == '+' ? 1 : -1;
    char sc = body[j];
    j++;
    std::string num;
    while (j < body.size() && isdigit((unsigned char)body[j]))
      num += body[j++];
    if (!num.empty()) charge += sign * std::stoi(num);
    else {
      charge += sign;
      while (j < body.size() && body[j] == sc) { charge += sign; j++; }
    }
  }

  if (j < body.size() && body[j] == ':') {
    j++;
    while (j < body.size() && isdigit((unsigned char)body[j])) j++;
  }
  if (j != body.size()) return false;

  atom.symbol = sym;
  atom.aromatic = aromatic;
  atom.charge = charge;
  atom.isotope = isotope;
  atom.explicit_hs = hs;
  atom.is_bracket = true;
  i = end + 1;
  return true;
}

bool parse_smiles(const std::string& s, Mol& mol) {
  std::vector<Atom> atoms;
  std::vector<Bond> bonds;
  int prev = -1;
  std::vector<int> branch;
  double pending = -1.0;  // -1 = none
  std::map<int, std::pair<int, double>> ring_marks;

  auto add_atom = [&](Atom a) {
    atoms.push_back(a);
    int idx = (int)atoms.size() - 1;
    if (prev >= 0) {
      double order = pending;
      bool arom = false;
      if (order < 0) {
        if (atoms[prev].aromatic && a.aromatic) { order = 1.5; arom = true; }
        else order = 1.0;
      } else if (order == 1.5) arom = true;
      bonds.push_back({prev, idx, order, arom, false});
    }
    prev = idx;
    pending = -1.0;
  };

  auto close_ring = [&](int num) -> bool {
    if (prev < 0) return false;
    auto it = ring_marks.find(num);
    if (it != ring_marks.end()) {
      int other = it->second.first;
      double obond = it->second.second;
      ring_marks.erase(it);
      double order = pending >= 0 ? pending : obond;
      bool arom = false;
      if (order < 0) {
        if (atoms[other].aromatic && atoms[prev].aromatic) {
          order = 1.5; arom = true;
        } else order = 1.0;
      } else if (order == 1.5) arom = true;
      if (other == prev) return false;
      bonds.push_back({other, prev, order, arom, false});
    } else {
      ring_marks[num] = {prev, pending};
    }
    pending = -1.0;
    return true;
  };

  size_t i = 0;
  const size_t n = s.size();
  while (i < n) {
    char c = s[i];
    if (c == '[') {
      Atom a;
      if (!parse_bracket(s, i, a)) return false;
      add_atom(a);
    } else if (isupper((unsigned char)c)) {
      std::string sym;
      if (s.compare(i, 2, "Cl") == 0 || s.compare(i, 2, "Br") == 0) {
        sym = s.substr(i, 2); i += 2;
      } else {
        sym = s.substr(i, 1); i += 1;
      }
      if (!kOrganic.count(sym)) return false;
      Atom a; a.symbol = sym;
      add_atom(a);
    } else if (strchr("bcnops", c)) {
      Atom a;
      a.symbol = std::string(1, (char)toupper((unsigned char)c));
      a.aromatic = true;
      add_atom(a);
      i++;
    } else if (c == '-' || c == '=' || c == '#' || c == ':' ||
               c == '/' || c == '\\') {
      if (pending >= 0 && c != '/' && c != '\\') return false;
      pending = (c == '=') ? 2.0 : (c == '#') ? 3.0 :
                (c == ':') ? 1.5 : 1.0;
      i++;
    } else if (isdigit((unsigned char)c)) {
      if (!close_ring(c - '0')) return false;
      i++;
    } else if (c == '%') {
      if (i + 2 >= n || !isdigit((unsigned char)s[i + 1]) ||
          !isdigit((unsigned char)s[i + 2]))
        return false;
      if (!close_ring((s[i + 1] - '0') * 10 + (s[i + 2] - '0')))
        return false;
      i += 3;
    } else if (c == '(') {
      if (prev < 0) return false;
      branch.push_back(prev);
      i++;
    } else if (c == ')') {
      if (branch.empty()) return false;
      prev = branch.back();
      branch.pop_back();
      i++;
    } else if (c == '.') {
      prev = -1;
      pending = -1.0;
      i++;
    } else if (c == ' ' || c == '\t') {
      break;
    } else {
      return false;
    }
  }
  if (!branch.empty() || !ring_marks.empty() || atoms.empty()) return false;

  // fold explicit hydrogen atoms into neighbor H counts
  std::vector<int> h_idxs;
  for (size_t k = 0; k < atoms.size(); ++k)
    if (atoms[k].symbol == "H" && atoms[k].isotope == 0 &&
        atoms[k].charge == 0)
      h_idxs.push_back((int)k);
  if (!h_idxs.empty()) {
    std::set<int> hset(h_idxs.begin(), h_idxs.end());
    std::vector<int> remap(atoms.size(), -1);
    std::vector<Atom> na;
    for (size_t k = 0; k < atoms.size(); ++k) {
      if (!hset.count((int)k)) {
        remap[k] = (int)na.size();
        Atom a = atoms[k];
        a.neighbors.clear(); a.bond_idxs.clear();
        a.explicit_hs = std::max(a.explicit_hs, 0);
        na.push_back(a);
      }
    }
    std::vector<Bond> nb;
    for (auto& b : bonds) {
      if (remap[b.a1] >= 0 && remap[b.a2] >= 0) {
        nb.push_back({remap[b.a1], remap[b.a2], b.order, b.aromatic, false});
      } else {
        int heavy = remap[b.a1] >= 0 ? remap[b.a1]
                   : (remap[b.a2] >= 0 ? remap[b.a2] : -1);
        if (heavy >= 0) {
          na[heavy].explicit_hs = std::max(na[heavy].explicit_hs, 0) + 1;
          na[heavy].is_bracket = true;
        }
      }
    }
    atoms = na;
    bonds = nb;
  }

  mol.atoms = atoms;
  mol.bonds = bonds;
  return true;
}

// ------------------------------------------------------------ perception
void build_adjacency(Mol& m) {
  for (auto& a : m.atoms) { a.neighbors.clear(); a.bond_idxs.clear(); }
  for (size_t i = 0; i < m.bonds.size(); ++i) {
    auto& b = m.bonds[i];
    m.atoms[b.a1].neighbors.push_back(b.a2);
    m.atoms[b.a2].neighbors.push_back(b.a1);
    m.atoms[b.a1].bond_idxs.push_back((int)i);
    m.atoms[b.a2].bond_idxs.push_back((int)i);
  }
}

std::vector<std::vector<int>> find_rings(Mol& m) {
  const int n = (int)m.atoms.size();
  // Tarjan bridges (iterative)
  std::vector<int> disc(n, -1), low(n, 0);
  std::vector<char> is_bridge(m.bonds.size(), 0);
  int timer = 0;
  struct Frame { int v; int pedge; int slot; };
  for (int root = 0; root < n; ++root) {
    if (disc[root] != -1) continue;
    std::vector<Frame> st;
    st.push_back({root, -1, 0});
    disc[root] = low[root] = timer++;
    while (!st.empty()) {
      Frame& top = st.back();
      int v = top.v, pedge = top.pedge;
      bool advanced = false;
      while (top.slot < (int)m.atoms[v].bond_idxs.size()) {
        int bidx = m.atoms[v].bond_idxs[top.slot++];
        if (bidx == pedge) continue;
        int w = m.bonds[bidx].other(v);
        if (disc[w] == -1) {
          disc[w] = low[w] = timer++;
          st.push_back({w, bidx, 0});
          advanced = true;
          break;
        } else {
          low[v] = std::min(low[v], disc[w]);
        }
      }
      if (!advanced && top.slot >= (int)m.atoms[v].bond_idxs.size()) {
        st.pop_back();
        if (!st.empty()) {
          int pv = st.back().v;
          low[pv] = std::min(low[pv], low[v]);
          if (low[v] > disc[pv]) is_bridge[pedge] = 1;
        }
      }
    }
  }
  for (size_t i = 0; i < m.bonds.size(); ++i)
    m.bonds[i].in_ring = !is_bridge[i];
  for (auto& a : m.atoms) {
    a.in_ring = false;
    for (int bi : a.bond_idxs)
      if (m.bonds[bi].in_ring) { a.in_ring = true; break; }
  }

  // ring enumeration: shortest cycle through each ring bond (<= 24,
  // matching Mol.MAX_RING in chem/smiles.py — covers common macrocycles)
  std::vector<std::vector<int>> rings;
  std::set<std::set<int>> seen;
  const int MAX_RING = 24;
  for (size_t bi = 0; bi < m.bonds.size(); ++bi) {
    auto& b = m.bonds[bi];
    if (!b.in_ring) continue;
    int src = b.a1, dst = b.a2;
    std::map<int, int> prev;
    prev[src] = -1;
    std::vector<int> frontier = {src};
    bool found = false;
    int depth = 0;
    while (!frontier.empty() && !found && depth < MAX_RING) {
      std::vector<int> nxt;
      for (int v : frontier) {
        for (int bidx : m.atoms[v].bond_idxs) {
          if (bidx == (int)bi) continue;
          auto& nb = m.bonds[bidx];
          if (!nb.in_ring) continue;
          int w = nb.other(v);
          if (prev.count(w)) continue;
          prev[w] = v;
          if (w == dst) { found = true; break; }
          nxt.push_back(w);
        }
        if (found) break;
      }
      frontier = nxt;
      depth++;
    }
    if (found) {
      std::vector<int> path = {dst};
      while (path.back() != src) path.push_back(prev[path.back()]);
      std::set<int> key(path.begin(), path.end());
      if (!seen.count(key) && (int)path.size() <= MAX_RING) {
        seen.insert(key);
        rings.push_back(path);
      }
    }
  }
  return rings;
}

void mark_ring_aromatic(Mol& m, const std::vector<int>& ring) {
  std::set<int> rs(ring.begin(), ring.end());
  for (int ai : ring) m.atoms[ai].aromatic = true;
  for (auto& b : m.bonds)
    if (rs.count(b.a1) && rs.count(b.a2) && b.in_ring) {
      b.aromatic = true;
      b.order = 1.5;
    }
}

// Hückel 4n+2 on 5/6-rings, iterated to a fixpoint so fused Kekule
// systems (indole, benzofuran) converge regardless of ring order: a bond
// already aromatized by a neighbouring ring counts as a pi contributor.
// Lone-pair donors (pyrrole-type N/O/S) are flagged so implicit-H
// assignment skips their aromatic valence bump (mirrors chem/smiles.py).
void aromatize(Mol& m, const std::vector<std::vector<int>>& rings) {
  std::vector<char> done(rings.size(), 0);
  bool changed = true;
  while (changed) {
    changed = false;
    for (size_t ri = 0; ri < rings.size(); ++ri) {
      const auto& ring = rings[ri];
      if (done[ri]) continue;
      if (ring.size() != 5 && ring.size() != 6) { done[ri] = 1; continue; }
      bool all_arom = true;
      for (int ai : ring) all_arom = all_arom && m.atoms[ai].aromatic;
      if (all_arom) {
        mark_ring_aromatic(m, ring);
        done[ri] = 1;
        changed = true;
        continue;
      }
      std::set<int> rs(ring.begin(), ring.end());
      int pi = 0;
      bool ok = true;
      std::vector<int> donors;
      for (int ai : ring) {
        auto& a = m.atoms[ai];
        if (a.symbol != "C" && a.symbol != "N" && a.symbol != "O" &&
            a.symbol != "S") { ok = false; break; }
        bool pi_in = false, exo_het = false, exo_c = false;
        for (int bi : a.bond_idxs) {
          auto& b = m.bonds[bi];
          bool in_this_ring = rs.count(b.other(ai)) != 0;
          if ((b.order == 2.0 || b.aromatic) && in_this_ring) pi_in = true;
          if (b.order == 2.0 && !in_this_ring) {
            const std::string& os = m.atoms[b.other(ai)].symbol;
            if (os == "O" || os == "S" || os == "N") exo_het = true;
            else exo_c = true;
          }
        }
        if (pi_in) pi += 1;
        // exocyclic double bond to a more electronegative atom: the ring
        // atom stays in the pi system contributing ZERO electrons
        // (2-pyridone aromatizes; quinone fails Hueckel at 4 electrons) —
        // mirrors chem/smiles.py::_aromatize_kekule_rings
        else if (exo_het) { /* pi += 0 */ }
        else if (exo_c) { ok = false; break; }
        else if (a.symbol == "N" || a.symbol == "O" || a.symbol == "S") {
          pi += 2; donors.push_back(ai);
        }
        else { ok = false; break; }
      }
      if (ok && pi % 4 == 2) {
        for (int ai : donors) m.atoms[ai].lp_donor = true;
        mark_ring_aromatic(m, ring);
        done[ri] = 1;
        changed = true;
      }
    }
  }
}

// Returns false when a neutral atom's total bond order exceeds its
// highest Daylight valence — chemically impossible input such as CO=C
// (mirrors the SmilesParseError raised in chem/smiles.py; VERDICT r3 #1a).
// Charged bracket atoms are exempt, as in the Python twin.
bool assign_implicit_hs(Mol& m) {
  for (auto& a : m.atoms) {
    auto it = kValences.find(a.symbol);
    if (a.is_bracket) {
      a.implicit_hs = 0;
      if (it != kValences.end() && a.charge == 0) {
        double order_sum = 0.0;
        for (int bi : a.bond_idxs) {
          auto& b = m.bonds[bi];
          order_sum += b.aromatic ? 1.0 : b.order;
        }
        int total = (int)(order_sum + 0.5) + std::max(a.explicit_hs, 0);
        if (total > it->second.back()) return false;
      }
      continue;
    }
    if (it == kValences.end()) { a.implicit_hs = 0; continue; }
    double order_sum = 0.0;
    for (int bi : a.bond_idxs) {
      auto& b = m.bonds[bi];
      order_sum += b.aromatic ? 1.0 : b.order;
    }
    int total = (int)(order_sum + 0.5);
    // aromatic +1 formal-double-bond bump, except for lone-pair donors
    // (pyrrole-type N keeps its H; mirrors chem/smiles.py)
    if (a.aromatic && !a.lp_donor && total + 1 <= it->second[0]) total += 1;
    a.implicit_hs = 0;
    bool fits = false;
    for (int v : it->second)
      if (total <= v) { a.implicit_hs = v - total; fits = true; break; }
    if (!fits) return false;
  }
  return true;
}

// Steric-number model (mirrors Mol._assign_hybridization in
// chem/smiles.py): orbitals = sigma bonds (degree + Hs) + lone pairs,
// lone pairs = (outer electrons - charge - bonded valence) / 2.
void assign_hybridization(Mol& m) {
  for (auto& a : m.atoms) {
    int ths = a.total_hs();
    if (a.degree() == 0 && ths == 0) { a.hyb = HYB_S; continue; }
    double order_sum = 0.0;
    for (int bi : a.bond_idxs) order_sum += m.bonds[bi].order;
    int bonded = (int)(order_sum + 0.5) + ths;
    auto it = kOuterElecs.find(a.symbol);
    int lone_pairs = 0;
    if (it != kOuterElecs.end()) {
      // C++ division truncates toward zero; match Python floor-division
      // by clamping the numerator at 0 first (result is never negative).
      int num = it->second - a.charge - bonded;
      lone_pairs = num > 0 ? num / 2 : 0;
    }
    int steric = a.degree() + ths + lone_pairs;
    if (steric <= 1) a.hyb = HYB_S;
    else if (steric == 2) a.hyb = HYB_SP;
    else if (steric == 3) a.hyb = HYB_SP2;
    else if (steric == 4) a.hyb = HYB_SP3;
    else if (steric == 5) a.hyb = HYB_SP3D;
    else a.hyb = HYB_SP3D2;
  }
}

bool perceive(Mol& m) {
  build_adjacency(m);
  auto rings = find_rings(m);
  aromatize(m, rings);
  if (!assign_implicit_hs(m)) return false;
  assign_hybridization(m);
  return true;
}

// ------------------------------------------------------------ featurizer
const char* kSymbols[9] = {"C", "N", "O", "S", "F", "P", "Cl", "Br", "I"};

void featurize35(const Mol& m, float* out /* n*35, pre-zeroed */) {
  for (size_t i = 0; i < m.atoms.size(); ++i) {
    const Atom& a = m.atoms[i];
    float* f = out + i * 35;
    int sidx = 9;  // Unknown
    for (int k = 0; k < 9; ++k)
      if (a.symbol == kSymbols[k]) { sidx = k; break; }
    f[sidx] = 1.0f;
    int deg = a.degree();
    if (deg >= 0 && deg <= 6) f[10 + deg] = 1.0f;
    int iv = a.implicit_hs;
    if (iv >= 0 && iv <= 6) f[17 + iv] = 1.0f;
    switch (a.hyb) {  // out-of-vocab (S/UNSPEC) stays all-zero
      case HYB_SP:    f[24] = 1.0f; break;
      case HYB_SP2:   f[25] = 1.0f; break;
      case HYB_SP3:   f[26] = 1.0f; break;
      case HYB_SP3D:  f[27] = 1.0f; break;
      case HYB_SP3D2: f[28] = 1.0f; break;
      default: break;
    }
    f[29] = a.aromatic ? 1.0f : 0.0f;
    int th = a.total_hs();
    if (th >= 0 && th <= 4) f[30 + th] = 1.0f;
  }
}

void featurize5(const Mol& m, float* out /* n*5, pre-zeroed */) {
  for (size_t i = 0; i < m.atoms.size(); ++i) {
    const Atom& a = m.atoms[i];
    float* f = out + i * 5;
    auto it = kAtomicNumbers.find(a.symbol);
    f[0] = it == kAtomicNumbers.end() ? 0.0f : (float)it->second;
    f[1] = (float)a.degree();
    f[2] = (float)a.implicit_hs;
    f[3] = (float)a.charge;
    f[4] = a.aromatic ? 1.0f : 0.0f;
  }
}

int edge_list(const Mol& m, int32_t* edges, int max_edges) {
  std::set<std::pair<int, int>> pairs;
  for (auto& b : m.bonds) {
    pairs.insert({b.a1, b.a2});
    pairs.insert({b.a2, b.a1});
  }
  if ((int)pairs.size() > max_edges) return -1;
  int k = 0;
  for (auto& p : pairs) {
    edges[k] = p.first;               // row 0: sources
    edges[max_edges + k] = p.second;  // row 1: destinations
    k++;
  }
  return k;
}

// --------------------------------------------------------------- morgan
const uint32_t TAG_ECFP0 = 1, TAG_FCFP0 = 2, TAG_ITER = 3;

uint32_t ecfp_invariant(const Atom& a) {
  auto it = kAtomicNumbers.find(a.symbol);
  uint32_t z = it == kAtomicNumbers.end() ? 0 : (uint32_t)it->second;
  return crc_ints(TAG_ECFP0, {
      z, (uint32_t)a.degree(), (uint32_t)a.total_hs(),
      (uint32_t)(int32_t)a.charge, (uint32_t)(a.in_ring ? 1 : 0),
      (uint32_t)(a.aromatic ? 1 : 0), (uint32_t)a.isotope});
}

uint32_t fcfp_invariant(const Atom& a) {
  const std::string& s = a.symbol;
  uint32_t donor = ((s == "N" || s == "O" || s == "S") && a.total_hs() > 0);
  uint32_t acceptor = ((s == "N" || s == "O") && a.charge <= 0);
  uint32_t basic = (s == "N" && !a.aromatic && a.charge >= 0);
  uint32_t acidic = (s == "O" && a.charge < 0);
  uint32_t aromatic = a.aromatic ? 1 : 0;
  uint32_t halogen = (s == "F" || s == "Cl" || s == "Br" || s == "I");
  return crc_ints(TAG_FCFP0, {donor, acceptor, basic, acidic,
                              aromatic, halogen});
}

void morgan(const Mol& m, int radius, int nbits, bool use_features,
            float* fp /* pre-zeroed nbits */) {
  const size_t n = m.atoms.size();
  std::vector<uint32_t> ids(n);
  for (size_t i = 0; i < n; ++i)
    ids[i] = use_features ? fcfp_invariant(m.atoms[i])
                          : ecfp_invariant(m.atoms[i]);
  std::vector<std::vector<int32_t>> env(n);  // sorted bond-id sets
  std::set<std::vector<int32_t>> seen_envs;
  for (size_t i = 0; i < n; ++i) fp[ids[i] % nbits] = 1.0f;

  for (int r = 1; r <= radius; ++r) {
    std::vector<uint32_t> new_ids(ids);
    std::vector<std::vector<int32_t>> new_env(env);
    // (atom order, new_id, env) — emitted sorted by new_id
    std::vector<std::pair<uint32_t, size_t>> round_items;
    for (size_t i = 0; i < n; ++i) {
      const Atom& a = m.atoms[i];
      std::vector<std::pair<uint32_t, uint32_t>> nb;
      std::set<int32_t> bonds_here(env[i].begin(), env[i].end());
      for (int bi : a.bond_idxs) {
        const Bond& b = m.bonds[bi];
        int j = b.other((int)i);
        nb.push_back({(uint32_t)(int)(b.order * 2.0), ids[j]});
        bonds_here.insert(bi);
        for (int32_t e : env[j]) bonds_here.insert(e);
      }
      std::sort(nb.begin(), nb.end());
      std::vector<uint32_t> stream = {(uint32_t)r, ids[i]};
      for (auto& p : nb) { stream.push_back(p.first);
                           stream.push_back(p.second); }
      new_ids[i] = crc_ints(TAG_ITER, stream);
      new_env[i].assign(bonds_here.begin(), bonds_here.end());
      round_items.push_back({new_ids[i], i});
    }
    std::sort(round_items.begin(), round_items.end());
    for (auto& it : round_items) {
      const auto& e = new_env[it.second];
      if (!e.empty()) {
        if (seen_envs.count(e)) continue;
        seen_envs.insert(e);
      }
      fp[it.first % nbits] = 1.0f;
    }
    ids = new_ids;
    env = new_env;
  }
}

// ------------------------------------------------------------ structure
// What the graph transformer reads beside the features
// (chem/featurize.py::bond_types and ::graph_structure, bit for bit): a
// bond type per directed edge (1 single, 2 double, 3 triple, 4 aromatic;
// of two bonds between one pair the first counts), and a breadth-first
// search from each atom that visits a node's neighbours in edge-list order
// and keeps the first discoverer as the predecessor. spd[i][j] is the
// path's length in bonds (-1: unreachable or padding), path[i][j][0..L)
// the types of its first L = min(spd, hops) bonds from i.
// edge_types [max_edges], degree [max_nodes], spd [max_nodes^2] and
// path [max_nodes^2 * hops] are filled whole, padding included.
void structure(const Mol& m, const int32_t* edges, int ne, int max_nodes,
               int max_edges, int hops, int8_t* edge_types, int8_t* degree,
               int8_t* spd, int8_t* path) {
  const int n = (int)m.atoms.size();
  std::map<std::pair<int, int>, int> code;
  for (auto& b : m.bonds) {
    const int t = (b.aromatic || b.order == 1.5) ? 4 : (int)b.order;
    code.insert({{b.a1, b.a2}, t});
    code.insert({{b.a2, b.a1}, t});
  }
  std::memset(edge_types, 0, (size_t)max_edges);
  std::memset(degree, 0, (size_t)max_nodes);
  std::memset(spd, -1, (size_t)max_nodes * max_nodes);
  std::memset(path, 0, (size_t)max_nodes * max_nodes * hops);
  std::vector<std::vector<std::pair<int, int>>> nbrs(n);
  for (int k = 0; k < ne; ++k) {
    const int a = edges[k], b = edges[max_edges + k];
    edge_types[k] = (int8_t)code[{a, b}];
    nbrs[a].push_back({b, edge_types[k]});
  }
  for (int i = 0; i < n; ++i) degree[i] = (int8_t)nbrs[i].size();
  std::vector<int> queue(n);
  for (int s = 0; s < n; ++s) {
    int8_t* dist = spd + (size_t)s * max_nodes;
    int8_t* row = path + (size_t)s * max_nodes * hops;
    dist[s] = 0;
    int head = 0, tail = 0;
    queue[tail++] = s;
    while (head < tail) {
      const int u = queue[head++];
      const int du = dist[u];
      for (auto& e : nbrs[u]) {
        const int v = e.first;
        if (dist[v] != -1) continue;
        dist[v] = (int8_t)(du + 1);
        std::memcpy(row + (size_t)v * hops, row + (size_t)u * hops,
                    (size_t)hops);
        if (du < hops) row[(size_t)v * hops + du] = (int8_t)e.second;
        queue[tail++] = v;
      }
    }
  }
}

// One molecule: features, edges and fingerprint (mgat_featurize), and with
// hops > 0 its structure (above).
int featurize_one(const char* smiles, int feat_dim, int max_nodes,
                  int max_edges, float* nodes, int32_t* edges,
                  int32_t* n_edges_out, float* fp, int fp_bits,
                  int fp_radius, int use_features, int hops,
                  int8_t* edge_types, int8_t* degree, int8_t* spd,
                  int8_t* path) {
  if (!smiles || !*smiles) return -1;
  Mol m;
  if (!parse_smiles(std::string(smiles), m)) return -1;
  if (!perceive(m)) return -1;
  const int n = (int)m.atoms.size();
  if (n > max_nodes) return -2;
  std::memset(nodes, 0, sizeof(float) * (size_t)max_nodes * feat_dim);
  if (feat_dim == 35) featurize35(m, nodes);
  else if (feat_dim == 5) featurize5(m, nodes);
  else return -1;
  std::memset(edges, 0, sizeof(int32_t) * 2 * (size_t)max_edges);
  int ne = edge_list(m, edges, max_edges);
  if (ne < 0) return -3;
  *n_edges_out = ne;
  if (fp && fp_bits > 0) {
    std::memset(fp, 0, sizeof(float) * (size_t)fp_bits);
    morgan(m, fp_radius, fp_bits, use_features != 0, fp);
  }
  if (hops > 0)
    structure(m, edges, ne, max_nodes, max_edges, hops, edge_types, degree,
              spd, path);
  return n;
}

// The batch call of mgat_featurize_batch (the comment there), with the
// structure when hops > 0.
int featurize_batch(const char* smiles_blob, const int32_t* offsets,
                    int n_mols, int feat_dim, int max_nodes, int max_edges,
                    float* nodes, int32_t* edges, int32_t* n_edges_out,
                    float* fp, int fp_bits, int fp_radius, int use_features,
                    int32_t* results, int n_workers, int hops,
                    int8_t* edge_types, int8_t* degree, int8_t* spd,
                    int8_t* path) {
  constexpr int kBlock = 16;
  const size_t node_stride = (size_t)max_nodes * feat_dim;
  const size_t edge_stride = 2 * (size_t)max_edges;
  const size_t pair_stride = (size_t)max_nodes * max_nodes;
  n_workers = std::max(1, std::min(n_workers, (n_mols + kBlock - 1) / kBlock));
  std::atomic<int> cursor{0};
  std::atomic<bool> failed{false};
  auto work = [&]() noexcept {
    try {
      for (;;) {
        const int lo = cursor.fetch_add(kBlock, std::memory_order_relaxed);
        if (lo >= n_mols || failed.load(std::memory_order_relaxed)) return;
        for (int i = lo; i < std::min(lo + kBlock, n_mols); ++i) {
          const bool st = hops > 0;
          results[i] = featurize_one(
              smiles_blob + offsets[i], feat_dim, max_nodes, max_edges,
              nodes + i * node_stride, edges + i * edge_stride,
              n_edges_out + i, fp ? fp + (size_t)i * fp_bits : nullptr,
              fp_bits, fp_radius, use_features, hops,
              st ? edge_types + (size_t)i * max_edges : nullptr,
              st ? degree + (size_t)i * max_nodes : nullptr,
              st ? spd + i * pair_stride : nullptr,
              st ? path + i * pair_stride * hops : nullptr);
        }
      }
    } catch (...) {
      failed.store(true, std::memory_order_relaxed);
    }
  };
  std::vector<std::thread> threads;
  try {
    threads.reserve(n_workers - 1);
    for (int w = 1; w < n_workers; ++w) threads.emplace_back(work);
  } catch (...) {
  }
  work();
  for (auto& t : threads) t.join();
  return failed.load() ? -1 : 1 + (int)threads.size();
}

}  // namespace

// ------------------------------------------------------------------ C ABI
extern "C" {

// Parse + featurize one SMILES.
// nodes: [max_nodes * feat_dim] float32, pre-zeroed by this function.
// edges: [2 * max_edges] int32 (row 0 = src, row 1 = dst), pre-zeroed.
// fp:    [fp_bits] float32 or NULL, pre-zeroed.
// feat_dim: 35 or 5.
// Returns n_atoms on success; -1 parse error; -2 over node budget;
// -3 over edge budget.
int mgat_featurize(const char* smiles, int feat_dim, int max_nodes,
                   int max_edges, float* nodes, int32_t* edges,
                   int32_t* n_edges_out, float* fp, int fp_bits,
                   int fp_radius, int use_features) {
  return featurize_one(smiles, feat_dim, max_nodes, max_edges, nodes, edges,
                       n_edges_out, fp, fp_bits, fp_radius, use_features, 0,
                       nullptr, nullptr, nullptr, nullptr);
}

// Batch variant: featurize many SMILES in one call (amortizes ctypes
// overhead). smiles_blob is NUL-separated, offsets gives where each starts.
// results[i] = n_atoms or negative error code per molecule.
//
// The molecules are split over n_workers threads, the calling thread being
// the last, and never more workers than blocks of kBlock molecules: each
// takes blocks from one shared cursor (a molecule's cost grows with its
// atoms and rings, so fixed ranges would leave one worker finishing last)
// and writes only its molecules' slots, so the outputs are the same bytes
// for any count. One worker starts no thread. A thread the system refuses
// leaves its blocks to the workers that started. Every thread is joined
// before the call returns. Returns the number of workers that ran, or -1
// when a molecule's featurisation threw (std::bad_alloc): the outputs are
// then incomplete.
int mgat_featurize_batch(const char* smiles_blob, const int32_t* offsets,
                         int n_mols, int feat_dim, int max_nodes,
                         int max_edges, float* nodes, int32_t* edges,
                         int32_t* n_edges_out, float* fp, int fp_bits,
                         int fp_radius, int use_features,
                         int32_t* results, int n_workers) {
  return featurize_batch(smiles_blob, offsets, n_mols, feat_dim, max_nodes,
                         max_edges, nodes, edges, n_edges_out, fp, fp_bits,
                         fp_radius, use_features, results, n_workers, 0,
                         nullptr, nullptr, nullptr, nullptr);
}

// mgat_featurize_batch, and per molecule its structure: edge_types
// [n_mols * max_edges], degree [n_mols * max_nodes], spd [n_mols *
// max_nodes^2] and path [n_mols * max_nodes^2 * hops] int8, as
// structure() above fills them (hops >= 1).
int mgat_featurize_batch_structure(
    const char* smiles_blob, const int32_t* offsets, int n_mols,
    int feat_dim, int max_nodes, int max_edges, float* nodes,
    int32_t* edges, int32_t* n_edges_out, float* fp, int fp_bits,
    int fp_radius, int use_features, int32_t* results, int n_workers,
    int hops, int8_t* edge_types, int8_t* degree, int8_t* spd,
    int8_t* path) {
  if (hops < 1) return -1;
  return featurize_batch(smiles_blob, offsets, n_mols, feat_dim, max_nodes,
                         max_edges, nodes, edges, n_edges_out, fp, fp_bits,
                         fp_radius, use_features, results, n_workers, hops,
                         edge_types, degree, spd, path);
}

}  // extern "C"
