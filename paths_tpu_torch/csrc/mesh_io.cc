// Host mesh parsers for the port's scene build: Wavefront OBJ and Stanford
// PLY.
//
// A copy of paths_tpu/native/mesh_io.cc, kept in the port so that it depends
// on nothing of the reference package, and built with the reference's flags
// (paths_tpu/native/Makefile) so that the two libraries return the same
// arrays bit for bit.  The reference links the tobj and ply-rs crates for the
// same job (the Rust renderer's src/obj.rs:8-67 and src/ply.rs:11-74).  The
// Python parsers are several times slower on a dragon-class mesh, so the
// loaders (scene/obj_loader.py, scene/ply_loader.py) call this library by
// default; their pure-Python paths (use_native=False) stay as the semantics
// reference.  Both split models on o/g, fan-triangulate polygons, re-index a
// model's vertices sorted and unique as np.unique does, keep texcoords only
// when every corner has one and read .mtl Kd.  Like the reference's, this
// parser scales a uchar colour by x * (1.0 / 255.0) where the Python path
// divides by 255.0: one ulp apart in f64 for some bytes, equal once cast to
// the scene's f32.
//
// Handle-based C ABI (bound with ctypes in paths_tpu_torch/native.py):
//   h = paths_obj_load(path, &n_models)        NULL on failure
//   paths_obj_model_info(h, i, &nv, &nf, &has_uv, &has_kd)
//   paths_obj_model_data(h, i, verts, faces, uvs, kd)   caller-allocated
//   paths_obj_free(h)
//   h = paths_ply_load(path, &nv, &nf, &has_col)      NULL on failure
//   paths_ply_data(h, verts, faces, cols)
//   paths_ply_free(h)

#include <algorithm>
#include <array>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// ---------- shared text utilities ----------

bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(&(*out)[0], 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

struct Cursor {
  const char* p;
  const char* end;
  bool done() const { return p >= end; }
  // Returns [line_start, line_end) and advances past the newline.
  bool next_line(const char** ls, const char** le) {
    if (done()) return false;
    *ls = p;
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (nl) {
      *le = nl;
      p = nl + 1;
    } else {
      *le = end;
      p = end;
    }
    return true;
  }
};

inline const char* skip_ws(const char* p, const char* e) {
  while (p < e && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_tok(const char* p, const char* e, const char** ts,
                            const char** te) {
  p = skip_ws(p, e);
  *ts = p;
  while (p < e && *p != ' ' && *p != '\t' && *p != '\r') ++p;
  *te = p;
  return p;
}

// ---------- OBJ ----------

struct ObjModel {
  std::vector<double> verts;  // (V, 3) packed
  std::vector<int64_t> faces;  // (F, 3)
  std::vector<double> uvs;  // (V, 2) when has_uv
  bool has_uv = false;
  bool has_kd = false;
  double kd[3] = {1.0, 1.0, 1.0};
};

struct ObjFile {
  std::vector<ObjModel> models;
};

void parse_mtl(const std::string& dir, const std::string& name,
               std::unordered_map<std::string, std::array<double, 3>>* mats) {
  std::string text;
  std::string path = dir.empty() ? name : dir + "/" + name;
  if (!read_file(path.c_str(), &text)) return;
  Cursor cur{text.data(), text.data() + text.size()};
  const char *ls, *le;
  std::string curname;
  while (cur.next_line(&ls, &le)) {
    const char *ts, *te;
    const char* p = next_tok(ls, le, &ts, &te);
    size_t n = static_cast<size_t>(te - ts);
    if (n == 6 && std::memcmp(ts, "newmtl", 6) == 0) {
      p = next_tok(p, le, &ts, &te);
      curname.assign(ts, te);
      (*mats)[curname] = {1.0, 1.0, 1.0};
    } else if (n == 2 && std::memcmp(ts, "Kd", 2) == 0 && !curname.empty()) {
      std::array<double, 3> kd;
      bool ok = true;
      for (int i = 0; i < 3; ++i) {
        p = next_tok(p, le, &ts, &te);
        if (ts == te) { ok = false; break; }
        kd[i] = std::strtod(ts, nullptr);
      }
      if (ok) (*mats)[curname] = kd;
    }
  }
}

// Flush accumulated faces into a model with re-indexed (sorted-unique,
// matching np.unique) per-model vertex buffers.
void obj_flush(const std::vector<double>& positions,
               const std::vector<double>& texcoords,
               std::vector<int64_t>* cur_faces,
               std::vector<int64_t>* cur_uvs, bool kd_valid,
               const double* kd, ObjFile* out) {
  if (cur_faces->empty()) return;
  ObjModel m;
  // Sorted unique vertex ids (np.unique ordering).
  std::vector<int64_t> used(*cur_faces);
  std::sort(used.begin(), used.end());
  used.erase(std::unique(used.begin(), used.end()), used.end());
  std::unordered_map<int64_t, int64_t> remap;
  remap.reserve(used.size() * 2);
  for (size_t i = 0; i < used.size(); ++i) remap[used[i]] = static_cast<int64_t>(i);
  m.verts.resize(used.size() * 3);
  for (size_t i = 0; i < used.size(); ++i) {
    for (int c = 0; c < 3; ++c)
      m.verts[3 * i + c] = positions[3 * static_cast<size_t>(used[i]) + c];
  }
  m.faces.resize(cur_faces->size());
  for (size_t i = 0; i < cur_faces->size(); ++i) m.faces[i] = remap[(*cur_faces)[i]];

  // Texcoords only when every corner has one (obj_loader.py semantics).
  bool all_uv = !texcoords.empty();
  for (int64_t u : *cur_uvs)
    if (u < 0) { all_uv = false; break; }
  if (all_uv && !cur_uvs->empty()) {
    m.has_uv = true;
    m.uvs.assign(used.size() * 2, 0.0);
    for (size_t i = 0; i < cur_faces->size(); ++i) {
      int64_t v = m.faces[i];
      int64_t u = (*cur_uvs)[i];
      m.uvs[2 * static_cast<size_t>(v)] = texcoords[2 * static_cast<size_t>(u)];
      m.uvs[2 * static_cast<size_t>(v) + 1] = texcoords[2 * static_cast<size_t>(u) + 1];
    }
  }
  if (kd_valid) {
    m.has_kd = true;
    std::memcpy(m.kd, kd, sizeof(m.kd));
  }
  out->models.push_back(std::move(m));
  cur_faces->clear();
  cur_uvs->clear();
}

ObjFile* obj_load(const char* path) {
  std::string text;
  if (!read_file(path, &text)) return nullptr;
  std::string dir;
  {
    const char* slash = std::strrchr(path, '/');
    if (slash) dir.assign(path, static_cast<size_t>(slash - path));
  }

  auto* out = new ObjFile();
  std::vector<double> positions, texcoords;
  std::vector<int64_t> cur_faces, cur_uvs;
  std::unordered_map<std::string, std::array<double, 3>> mats;
  std::string cur_mtl;

  Cursor cur{text.data(), text.data() + text.size()};
  const char *ls, *le;
  std::vector<int64_t> idx, uvi;
  while (cur.next_line(&ls, &le)) {
    const char *ts, *te;
    const char* p = next_tok(ls, le, &ts, &te);
    size_t n = static_cast<size_t>(te - ts);
    if (n == 1 && *ts == 'v') {
      for (int c = 0; c < 3; ++c) {
        p = next_tok(p, le, &ts, &te);
        positions.push_back(ts == te ? 0.0 : std::strtod(ts, nullptr));
      }
    } else if (n == 2 && ts[0] == 'v' && ts[1] == 't') {
      for (int c = 0; c < 2; ++c) {
        p = next_tok(p, le, &ts, &te);
        texcoords.push_back(ts == te ? 0.0 : std::strtod(ts, nullptr));
      }
    } else if (n == 1 && *ts == 'f') {
      idx.clear();
      uvi.clear();
      while (true) {
        p = next_tok(p, le, &ts, &te);
        if (ts == te) break;
        // v[/vt[/vn]] with 1-based or negative indices.
        char* after = nullptr;
        long long v = std::strtoll(ts, &after, 10);
        int64_t vcount = static_cast<int64_t>(positions.size() / 3);
        idx.push_back(v > 0 ? v - 1 : vcount + v);
        int64_t u = -1;
        if (after < te && *after == '/') {
          const char* us = after + 1;
          if (us < te && *us != '/') {
            long long t = std::strtoll(us, nullptr, 10);
            int64_t tcount = static_cast<int64_t>(texcoords.size() / 2);
            u = t > 0 ? t - 1 : tcount + t;
          }
        }
        uvi.push_back(u);
      }
      // Fan triangulation (tobj triangulate=true; obj_loader.py).
      for (size_t k = 1; k + 1 < idx.size(); ++k) {
        cur_faces.push_back(idx[0]);
        cur_faces.push_back(idx[k]);
        cur_faces.push_back(idx[k + 1]);
        cur_uvs.push_back(uvi[0]);
        cur_uvs.push_back(uvi[k]);
        cur_uvs.push_back(uvi[k + 1]);
      }
    } else if ((n == 1 && (*ts == 'o' || *ts == 'g'))) {
      auto it = mats.find(cur_mtl);
      obj_flush(positions, texcoords, &cur_faces, &cur_uvs,
                it != mats.end(), it != mats.end() ? it->second.data() : nullptr,
                out);
    } else if (n == 6 && std::memcmp(ts, "usemtl", 6) == 0) {
      p = next_tok(p, le, &ts, &te);
      cur_mtl.assign(ts, te);
    } else if (n == 6 && std::memcmp(ts, "mtllib", 6) == 0) {
      p = next_tok(p, le, &ts, &te);
      parse_mtl(dir, std::string(ts, te), &mats);
    }
  }
  auto it = mats.find(cur_mtl);
  obj_flush(positions, texcoords, &cur_faces, &cur_uvs,
            it != mats.end(), it != mats.end() ? it->second.data() : nullptr,
            out);
  return out;
}

// ---------- PLY ----------

struct PlyData {
  std::vector<double> verts;  // (V, 3)
  std::vector<int64_t> faces;  // (F, 3)
  std::vector<double> cols;  // (V, 3) in [0,1] when has_col
  bool has_col = false;
};

int type_size(const std::string& t) {
  if (t == "char" || t == "int8" || t == "uchar" || t == "uint8") return 1;
  if (t == "short" || t == "int16" || t == "ushort" || t == "uint16") return 2;
  if (t == "int" || t == "int32" || t == "uint" || t == "uint32" ||
      t == "float" || t == "float32")
    return 4;
  if (t == "double" || t == "float64") return 8;
  return 0;
}

double read_scalar(const unsigned char* p, const std::string& t, bool big) {
  auto load = [&](int n) -> uint64_t {
    uint64_t v = 0;
    if (big)
      for (int i = 0; i < n; ++i) v = (v << 8) | p[i];
    else
      for (int i = n - 1; i >= 0; --i) v = (v << 8) | p[i];
    return v;
  };
  if (t == "uchar" || t == "uint8") return static_cast<double>(load(1));
  if (t == "char" || t == "int8") return static_cast<double>(static_cast<int8_t>(load(1)));
  if (t == "ushort" || t == "uint16") return static_cast<double>(load(2));
  if (t == "short" || t == "int16") return static_cast<double>(static_cast<int16_t>(load(2)));
  if (t == "uint" || t == "uint32") return static_cast<double>(load(4));
  if (t == "int" || t == "int32") return static_cast<double>(static_cast<int32_t>(load(4)));
  if (t == "float" || t == "float32") {
    uint32_t u = static_cast<uint32_t>(load(4));
    float f;
    std::memcpy(&f, &u, 4);
    return f;
  }
  uint64_t u = load(8);
  double d;
  std::memcpy(&d, &u, 8);
  return d;
}

struct PlyProp {
  bool is_list;
  std::string count_t, item_t, name;
};

PlyData* ply_load(const char* path) {
  std::string text;
  if (!read_file(path, &text)) return nullptr;
  size_t hdr_end = text.find("end_header");
  if (hdr_end == std::string::npos) return nullptr;
  size_t body_at = text.find('\n', hdr_end);
  if (body_at == std::string::npos) return nullptr;
  ++body_at;

  std::string fmt = "ascii";
  struct Elem {
    std::string name;
    int64_t count;
    std::vector<PlyProp> props;
  };
  std::vector<Elem> elems;
  {
    Cursor cur{text.data(), text.data() + hdr_end};
    const char *ls, *le;
    while (cur.next_line(&ls, &le)) {
      const char *ts, *te;
      const char* p = next_tok(ls, le, &ts, &te);
      std::string tag(ts, te);
      if (tag == "format") {
        p = next_tok(p, le, &ts, &te);
        fmt.assign(ts, te);
      } else if (tag == "element") {
        Elem e;
        p = next_tok(p, le, &ts, &te);
        e.name.assign(ts, te);
        p = next_tok(p, le, &ts, &te);
        e.count = std::strtoll(std::string(ts, te).c_str(), nullptr, 10);
        elems.push_back(std::move(e));
      } else if (tag == "property" && !elems.empty()) {
        p = next_tok(p, le, &ts, &te);
        std::string t1(ts, te);
        PlyProp pr;
        if (t1 == "list") {
          pr.is_list = true;
          p = next_tok(p, le, &ts, &te);
          pr.count_t.assign(ts, te);
          p = next_tok(p, le, &ts, &te);
          pr.item_t.assign(ts, te);
          p = next_tok(p, le, &ts, &te);
          pr.name.assign(ts, te);
        } else {
          pr.is_list = false;
          pr.count_t = t1;
          p = next_tok(p, le, &ts, &te);
          pr.name.assign(ts, te);
        }
        elems.back().props.push_back(std::move(pr));
      }
    }
  }

  auto* out = new PlyData();
  bool big = fmt == "binary_big_endian";
  bool binary = fmt != "ascii";

  const unsigned char* bp =
      reinterpret_cast<const unsigned char*>(text.data()) + body_at;
  const unsigned char* bend =
      reinterpret_cast<const unsigned char*>(text.data()) + text.size();
  Cursor acur{text.data() + body_at, text.data() + text.size()};

  for (const auto& e : elems) {
    bool is_vertex = e.name == "vertex";
    bool is_face = e.name == "face";
    int xi = -1, yi = -1, zi = -1, ri = -1, gi = -1, bi = -1, li = -1;
    for (size_t i = 0; i < e.props.size(); ++i) {
      const std::string& nm = e.props[i].name;
      if (nm == "x") xi = static_cast<int>(i);
      else if (nm == "y") yi = static_cast<int>(i);
      else if (nm == "z") zi = static_cast<int>(i);
      else if (nm == "red" || nm == "r") ri = static_cast<int>(i);
      else if (nm == "green" || nm == "g") gi = static_cast<int>(i);
      else if (nm == "blue" || nm == "b") bi = static_cast<int>(i);
      if (e.props[i].is_list &&
          (nm == "vertex_indices" || nm == "vertex_index"))
        li = static_cast<int>(i);
    }
    bool has_col = ri >= 0 && gi >= 0 && bi >= 0;
    if (is_vertex) {
      out->verts.reserve(static_cast<size_t>(e.count) * 3);
      if (has_col) {
        out->has_col = true;
        out->cols.reserve(static_cast<size_t>(e.count) * 3);
      }
    }

    std::vector<double> row(e.props.size());
    std::vector<int64_t> face_idx;
    for (int64_t r = 0; r < e.count; ++r) {
      face_idx.clear();
      if (binary) {
        for (size_t i = 0; i < e.props.size(); ++i) {
          const PlyProp& pr = e.props[i];
          if (pr.is_list) {
            if (bp + type_size(pr.count_t) > bend) { delete out; return nullptr; }
            int64_t cnt = static_cast<int64_t>(read_scalar(bp, pr.count_t, big));
            bp += type_size(pr.count_t);
            int isz = type_size(pr.item_t);
            if (bp + cnt * isz > bend) { delete out; return nullptr; }
            for (int64_t k = 0; k < cnt; ++k) {
              double v = read_scalar(bp, pr.item_t, big);
              bp += isz;
              if (static_cast<int>(i) == li) face_idx.push_back(static_cast<int64_t>(v));
            }
            row[i] = 0.0;
          } else {
            int sz = type_size(pr.count_t);
            if (bp + sz > bend) { delete out; return nullptr; }
            row[i] = read_scalar(bp, pr.count_t, big);
            bp += sz;
          }
        }
      } else {
        const char *ls, *le;
        if (!acur.next_line(&ls, &le)) { delete out; return nullptr; }
        const char* p = ls;
        for (size_t i = 0; i < e.props.size(); ++i) {
          const char *ts, *te;
          const PlyProp& pr = e.props[i];
          if (pr.is_list) {
            p = next_tok(p, le, &ts, &te);
            int64_t cnt = std::strtoll(ts, nullptr, 10);
            for (int64_t k = 0; k < cnt; ++k) {
              p = next_tok(p, le, &ts, &te);
              if (static_cast<int>(i) == li)
                face_idx.push_back(std::strtoll(ts, nullptr, 10));
            }
            row[i] = 0.0;
          } else {
            p = next_tok(p, le, &ts, &te);
            row[i] = ts == te ? 0.0 : std::strtod(ts, nullptr);
          }
        }
      }

      if (is_vertex && xi >= 0 && yi >= 0 && zi >= 0) {
        out->verts.push_back(row[static_cast<size_t>(xi)]);
        out->verts.push_back(row[static_cast<size_t>(yi)]);
        out->verts.push_back(row[static_cast<size_t>(zi)]);
        if (has_col) {
          // uchar colours scaled by 1/255 (ply.rs:62-68); float colours as-is.
          double s = type_size(e.props[static_cast<size_t>(ri)].count_t) == 1
                         ? (1.0 / 255.0)
                         : 1.0;
          out->cols.push_back(row[static_cast<size_t>(ri)] * s);
          out->cols.push_back(row[static_cast<size_t>(gi)] * s);
          out->cols.push_back(row[static_cast<size_t>(bi)] * s);
        }
      } else if (is_face && li >= 0) {
        // Fan-triangulate polygons (ply_loader.py).
        for (size_t k = 1; k + 1 < face_idx.size(); ++k) {
          out->faces.push_back(face_idx[0]);
          out->faces.push_back(face_idx[k]);
          out->faces.push_back(face_idx[k + 1]);
        }
      }
    }
  }
  return out;
}

}  // namespace

extern "C" {

void* paths_obj_load(const char* path, int64_t* n_models) {
  ObjFile* f = obj_load(path);
  if (!f) return nullptr;
  *n_models = static_cast<int64_t>(f->models.size());
  return f;
}

int paths_obj_model_info(void* h, int64_t i, int64_t* n_verts,
                         int64_t* n_faces, int32_t* has_uv, int32_t* has_kd) {
  auto* f = static_cast<ObjFile*>(h);
  if (i < 0 || i >= static_cast<int64_t>(f->models.size())) return 1;
  const ObjModel& m = f->models[static_cast<size_t>(i)];
  *n_verts = static_cast<int64_t>(m.verts.size() / 3);
  *n_faces = static_cast<int64_t>(m.faces.size() / 3);
  *has_uv = m.has_uv ? 1 : 0;
  *has_kd = m.has_kd ? 1 : 0;
  return 0;
}

int paths_obj_model_data(void* h, int64_t i, double* verts, int64_t* faces,
                         double* uvs, double* kd) {
  auto* f = static_cast<ObjFile*>(h);
  if (i < 0 || i >= static_cast<int64_t>(f->models.size())) return 1;
  const ObjModel& m = f->models[static_cast<size_t>(i)];
  std::memcpy(verts, m.verts.data(), m.verts.size() * sizeof(double));
  std::memcpy(faces, m.faces.data(), m.faces.size() * sizeof(int64_t));
  if (m.has_uv && uvs) std::memcpy(uvs, m.uvs.data(), m.uvs.size() * sizeof(double));
  if (m.has_kd && kd) std::memcpy(kd, m.kd, sizeof(m.kd));
  return 0;
}

void paths_obj_free(void* h) { delete static_cast<ObjFile*>(h); }

void* paths_ply_load(const char* path, int64_t* n_verts, int64_t* n_faces,
                     int32_t* has_col) {
  PlyData* d = ply_load(path);
  if (!d) return nullptr;
  *n_verts = static_cast<int64_t>(d->verts.size() / 3);
  *n_faces = static_cast<int64_t>(d->faces.size() / 3);
  *has_col = d->has_col ? 1 : 0;
  return d;
}

int paths_ply_data(void* h, double* verts, int64_t* faces, double* cols) {
  auto* d = static_cast<PlyData*>(h);
  std::memcpy(verts, d->verts.data(), d->verts.size() * sizeof(double));
  std::memcpy(faces, d->faces.data(), d->faces.size() * sizeof(int64_t));
  if (d->has_col && cols)
    std::memcpy(cols, d->cols.data(), d->cols.size() * sizeof(double));
  return 0;
}

void paths_ply_free(void* h) { delete static_cast<PlyData*>(h); }

}  // extern "C"
