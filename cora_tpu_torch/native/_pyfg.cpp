// Fast PyFG tokenizer — native IO path for large factor-graph files.
//
// The reference implements its parser in C++ (src/pyfg_text_parser.cpp);
// this is cora_tpu_torch's own copy of the JAX package's tokenizer
// (cora_tpu/native/_pyfg.cpp): a dependency-free C++17 scanner that
// tokenizes the 13 PyFG record types into flat numeric/symbol arrays.
// All *semantic* conversion (angle/quaternion → rotation matrices,
// upper-triangular covariance expansion) stays in Python
// (cora_tpu_torch/io/pyfg.py) so both paths share one implementation of
// the math and agree bit-for-bit.
//
// Exposed via a C ABI consumed with ctypes (no pybind11 dependency).

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Family {
  POSE = 0,
  LANDMARK = 1,
  POSE_PRIOR = 2,
  LANDMARK_PRIOR = 3,
  REL_POSE = 4,
  REL_POSE_LANDMARK = 5,
  RANGE = 6,
  NUM_FAMILIES = 7,
};

struct FamilyData {
  int width = 0;  // numeric values per record
  std::vector<unsigned char> chrs;  // 1 or 2 symbols per record
  std::vector<long long> idxs;
  std::vector<double> vals;
  int syms_per_record = 1;
};

struct Parsed {
  int dim = 0;
  FamilyData fam[NUM_FAMILIES];
  std::string error;
};

// numeric widths per family for 2D / 3D problems (excluding symbols;
// the leading timestamp is dropped, ground truth is kept)
void set_widths(Parsed *p, int dim) {
  p->dim = dim;
  const bool is2d = dim == 2;
  p->fam[POSE].width = is2d ? 3 : 7;                 // x y theta | xyz quat
  p->fam[LANDMARK].width = dim;                      // position
  p->fam[POSE_PRIOR].width = is2d ? 3 + 6 : 7 + 21;  // pose + ut cov
  p->fam[LANDMARK_PRIOR].width = is2d ? 2 + 3 : 3 + 6;
  p->fam[REL_POSE].width = is2d ? 3 + 6 : 7 + 21;
  p->fam[REL_POSE_LANDMARK].width = is2d ? 2 + 3 : 3 + 6;
  p->fam[RANGE].width = 2;  // range, cov
  p->fam[REL_POSE].syms_per_record = 2;
  p->fam[REL_POSE_LANDMARK].syms_per_record = 2;
  p->fam[RANGE].syms_per_record = 2;
}

struct Scanner {
  const char *cur;
  const char *end;

  bool skip_ws() {
    while (cur < end && (*cur == ' ' || *cur == '\t' || *cur == '\r')) ++cur;
    return cur < end && *cur != '\n';
  }

  // token = run of non-whitespace
  bool token(const char **tok, size_t *len) {
    if (!skip_ws()) return false;
    const char *start = cur;
    while (cur < end && !isspace(static_cast<unsigned char>(*cur))) ++cur;
    *tok = start;
    *len = static_cast<size_t>(cur - start);
    return *len > 0;
  }

  bool number(double *out) {
    if (!skip_ws()) return false;
    char *next = nullptr;
    *out = strtod(cur, &next);
    if (next == cur) return false;
    cur = next;
    return true;
  }

  void next_line() {
    while (cur < end && *cur != '\n') ++cur;
    if (cur < end) ++cur;
  }
};

bool parse_symbol(const char *tok, size_t len, unsigned char *chr,
                  long long *idx) {
  if (len < 2) return false;
  *chr = static_cast<unsigned char>(tok[0]);
  long long v = 0;
  for (size_t i = 1; i < len; ++i) {
    if (tok[i] < '0' || tok[i] > '9') return false;
    v = v * 10 + (tok[i] - '0');
  }
  *idx = v;
  return true;
}

struct Tag {
  const char *name;
  Family family;
  int dim;       // 2, 3, or 0 (range: either)
  bool has_ts;   // leading timestamp to skip
};

const Tag kTags[] = {
    {"VERTEX_SE2:PRIOR", POSE_PRIOR, 2, true},
    {"VERTEX_SE3:QUAT:PRIOR", POSE_PRIOR, 3, true},
    {"VERTEX_SE2", POSE, 2, true},
    {"VERTEX_SE3:QUAT", POSE, 3, true},
    {"VERTEX_XY:PRIOR", LANDMARK_PRIOR, 2, true},
    {"VERTEX_XYZ:PRIOR", LANDMARK_PRIOR, 3, true},
    {"VERTEX_XY", LANDMARK, 2, false},
    {"VERTEX_XYZ", LANDMARK, 3, false},
    {"EDGE_SE2_XY", REL_POSE_LANDMARK, 2, true},
    {"EDGE_SE3_XYZ", REL_POSE_LANDMARK, 3, true},
    {"EDGE_SE2", REL_POSE, 2, true},
    {"EDGE_SE3:QUAT", REL_POSE, 3, true},
    {"EDGE_RANGE", RANGE, 0, true},
};

}  // namespace

extern "C" {

void *pyfg_parse(const char *path) {
  auto *p = new Parsed();
  FILE *f = fopen(path, "rb");
  if (!f) {
    p->error = std::string("could not open file ") + path;
    return p;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    fclose(f);
    p->error = "short read";
    return p;
  }
  fclose(f);

  Scanner sc{buf.data(), buf.data() + buf.size()};
  long line_no = 0;
  while (sc.cur < sc.end) {
    ++line_no;
    const char *tok;
    size_t len;
    if (!sc.token(&tok, &len)) {
      sc.next_line();
      continue;
    }
    const Tag *tag = nullptr;
    for (const Tag &t : kTags) {
      size_t n = strlen(t.name);
      if (len == n && memcmp(tok, t.name, n) == 0) {
        tag = &t;
        break;
      }
    }
    if (!tag) {
      p->error = "unknown PyFG record type '" + std::string(tok, len) +
                 "' at line " + std::to_string(line_no);
      return p;
    }
    if (p->dim == 0) {
      int d = tag->dim ? tag->dim : 0;
      if (d == 0) {
        p->error = "cannot determine dimension from first record";
        return p;
      }
      set_widths(p, d);
    }

    FamilyData &fd = p->fam[tag->family];
    double ts;
    if (tag->has_ts && !sc.number(&ts)) {
      p->error = "missing timestamp at line " + std::to_string(line_no);
      return p;
    }
    for (int s = 0; s < fd.syms_per_record; ++s) {
      const char *st;
      size_t sl;
      unsigned char c;
      long long idx;
      if (!sc.token(&st, &sl) || !parse_symbol(st, sl, &c, &idx)) {
        p->error = "bad symbol at line " + std::to_string(line_no);
        return p;
      }
      fd.chrs.push_back(c);
      fd.idxs.push_back(idx);
    }
    for (int k = 0; k < fd.width; ++k) {
      double v;
      if (!sc.number(&v)) {
        p->error = "missing value " + std::to_string(k) + " at line " +
                   std::to_string(line_no);
        return p;
      }
      fd.vals.push_back(v);
    }
    sc.next_line();
  }
  return p;
}

int pyfg_dim(void *h) { return static_cast<Parsed *>(h)->dim; }

const char *pyfg_error(void *h) {
  Parsed *p = static_cast<Parsed *>(h);
  return p->error.empty() ? nullptr : p->error.c_str();
}

long long pyfg_count(void *h, int family) {
  FamilyData &fd = static_cast<Parsed *>(h)->fam[family];
  return fd.syms_per_record
             ? static_cast<long long>(fd.idxs.size() / fd.syms_per_record)
             : 0;
}

int pyfg_width(void *h, int family) {
  return static_cast<Parsed *>(h)->fam[family].width;
}

int pyfg_syms_per_record(void *h, int family) {
  return static_cast<Parsed *>(h)->fam[family].syms_per_record;
}

void pyfg_get_syms(void *h, int family, unsigned char *chrs, long long *idxs) {
  FamilyData &fd = static_cast<Parsed *>(h)->fam[family];
  memcpy(chrs, fd.chrs.data(), fd.chrs.size());
  memcpy(idxs, fd.idxs.data(), fd.idxs.size() * sizeof(long long));
}

void pyfg_get_vals(void *h, int family, double *out) {
  FamilyData &fd = static_cast<Parsed *>(h)->fam[family];
  memcpy(out, fd.vals.data(), fd.vals.size() * sizeof(double));
}

void pyfg_free(void *h) { delete static_cast<Parsed *>(h); }

}  // extern "C"
