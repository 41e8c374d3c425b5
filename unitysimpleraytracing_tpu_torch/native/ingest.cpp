// Native host-ingest: fast Wavefront OBJ parser.
//
// The reference leans on Unity's asset importer to feed its host ingest loop
// (Assets/_Scripts/MeshBufferContainer.cs:117-121); this framework's host-side
// data loader is this C++ library (the IO/runtime component kept native), with
// core/mesh.load_obj as the pure-Python fallback. Semantics are identical to
// the Python parser: v/vt/vn/f records, fan triangulation of polygons,
// 1-based indices with negative-relative support, missing vt/vn -> zeros.
//
// Output layout matches MeshData: flattened per-corner arrays
//   pos (T,3,3) f32, uv (T,3,2) f32, nrm (T,3,3) f32.
//
// Build: native/__init__.py compiles this file and image.cpp with g++ into one
// shared library under build/ at first use.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct Corner {
  long v, t, n;  // resolved 0-based indices; -1 = absent
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

}  // namespace

extern "C" {

typedef struct {
  float* pos;     // (n_tris * 9) floats
  float* uv;      // (n_tris * 6) floats
  float* nrm;     // (n_tris * 9) floats
  long n_tris;
  int has_uv;
  int has_nrm;
} ObjMesh;

const char* obj_last_error() { return g_error.c_str(); }

void obj_free(ObjMesh* m) {
  if (!m) return;
  std::free(m->pos);
  std::free(m->uv);
  std::free(m->nrm);
  std::free(m);
}

ObjMesh* obj_load(const char* path) {
  g_error.clear();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    g_error = std::string("cannot open ") + path;
    return nullptr;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    std::fclose(f);
    g_error = "short read";
    return nullptr;
  }
  std::fclose(f);

  std::vector<float> vs, vts, vns;          // packed xyz / uv / xyz
  std::vector<Corner> tri_corners;          // 3 per triangle
  std::vector<Corner> face;                 // scratch per face

  const char* p = buf.data();
  const char* end = p + buf.size();
  while (p < end) {
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    p = skip_ws(p, line_end);
    if (p < line_end) {
      if (p[0] == 'v' && p + 1 < line_end &&
          (p[1] == ' ' || p[1] == '\t')) {  // vertex position
        char* q = const_cast<char*>(p + 1);
        for (int k = 0; k < 3; ++k) vs.push_back(std::strtof(q, &q));
      } else if (p[0] == 'v' && p + 2 < line_end && p[1] == 't' &&
                 (p[2] == ' ' || p[2] == '\t')) {  // texcoord
        char* q = const_cast<char*>(p + 2);
        for (int k = 0; k < 2; ++k) vts.push_back(std::strtof(q, &q));
      } else if (p[0] == 'v' && p + 2 < line_end && p[1] == 'n' &&
                 (p[2] == ' ' || p[2] == '\t')) {  // normal
        char* q = const_cast<char*>(p + 2);
        for (int k = 0; k < 3; ++k) vns.push_back(std::strtof(q, &q));
      } else if (p[0] == 'f' && p + 1 < line_end &&
                 (p[1] == ' ' || p[1] == '\t')) {  // face
        face.clear();
        const char* q = p + 1;
        while (true) {
          q = skip_ws(q, line_end);
          if (q >= line_end) break;
          char* qe = nullptr;
          long vi = std::strtol(q, &qe, 10);
          if (qe == q) break;
          q = qe;
          long ti = 0, ni = 0;
          if (q < line_end && *q == '/') {
            ++q;
            if (q < line_end && *q != '/') {
              ti = std::strtol(q, &qe, 10);
              q = qe;
            }
            if (q < line_end && *q == '/') {
              ++q;
              ni = std::strtol(q, &qe, 10);
              q = qe;
            }
          }
          Corner c;
          long nv = static_cast<long>(vs.size() / 3);
          long nt = static_cast<long>(vts.size() / 2);
          long nn = static_cast<long>(vns.size() / 3);
          c.v = vi > 0 ? vi - 1 : nv + vi;
          c.t = ti > 0 ? ti - 1 : (ti < 0 ? nt + ti : -1);
          c.n = ni > 0 ? ni - 1 : (ni < 0 ? nn + ni : -1);
          face.push_back(c);
        }
        for (size_t k = 1; k + 1 < face.size(); ++k) {  // fan triangulation
          tri_corners.push_back(face[0]);
          tri_corners.push_back(face[k]);
          tri_corners.push_back(face[k + 1]);
        }
      }
    }
    p = next_line(line_end, end);
  }

  long T = static_cast<long>(tri_corners.size() / 3);
  ObjMesh* m = static_cast<ObjMesh*>(std::calloc(1, sizeof(ObjMesh)));
  m->n_tris = T;
  m->has_uv = vts.empty() ? 0 : 1;
  m->has_nrm = vns.empty() ? 0 : 1;
  m->pos = static_cast<float*>(std::calloc(static_cast<size_t>(T) * 9, 4));
  m->uv = static_cast<float*>(std::calloc(static_cast<size_t>(T) * 6, 4));
  m->nrm = static_cast<float*>(std::calloc(static_cast<size_t>(T) * 9, 4));

  long nv = static_cast<long>(vs.size() / 3);
  long nt = static_cast<long>(vts.size() / 2);
  long nn = static_cast<long>(vns.size() / 3);
  for (long i = 0; i < T * 3; ++i) {
    const Corner& c = tri_corners[static_cast<size_t>(i)];
    if (c.v < 0 || c.v >= nv) {
      g_error = "vertex index out of range";
      obj_free(m);
      return nullptr;
    }
    std::memcpy(m->pos + i * 3, &vs[static_cast<size_t>(c.v) * 3], 12);
    if (c.t >= 0 && c.t < nt)
      std::memcpy(m->uv + i * 2, &vts[static_cast<size_t>(c.t) * 2], 8);
    if (c.n >= 0 && c.n < nn)
      std::memcpy(m->nrm + i * 3, &vns[static_cast<size_t>(c.n) * 3], 12);
  }
  return m;
}

}  // extern "C"
