// cge_host — native host-side runtime for cge_tpu_torch.
//
// The port's own copy of the JAX package's host library
// (cge_tpu/native/cge_host.cpp): the reference ships its host-side
// components as native code (the OBJ pipeline as tinyobjloader + loadMesh,
// framework/src/mesh.cpp:52-176), and this library is their counterpart
// around the port's CUDA kernels:
//
//   - OBJ/MTL parsing + submesh splitting + vertex dedup + normalization
//     with the exact semantics of the reference pipeline (equivalence-
//     tested against cge_tpu_torch.scene.mesh_io's numpy loader, its twin);
//   - the spatial-median cluster builder feeding the cluster sweep
//     (cge_tpu_torch.ops.bvh.build_clusters semantics);
//   - the reference-parity BVH builder (median nth_element split on axis
//     depth % 3, or SAH binning; leaf iff depth+1 == 16 or one primitive,
//     src/bounding_volume_hierarchy.cpp:74-147).
//
// Exposed as a plain-C ABI consumed via ctypes. Built at first use by
// cge_tpu_torch/native/__init__.py (g++ -O2 -std=c++17 -fPIC -Wall -Wextra
// -Werror -shared) into build/cge_tpu_torch/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <numeric>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vec3 {
    float x = 0, y = 0, z = 0;
};

static inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline Vec3 cross(Vec3 a, Vec3 b)
{
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline float len(Vec3 a) { return std::sqrt(dot(a, a)); }

struct MaterialRec {
    float kd[3] = {0, 0, 0};
    float ks[3] = {0, 0, 0};
    float shininess = 1.0f;
    float dissolve = 1.0f;
    std::string map_kd;
};

struct SubMeshRec {
    std::vector<float> positions;  // 3 * V
    std::vector<float> normals;    // 3 * V
    std::vector<float> texcoords;  // 2 * V
    std::vector<uint32_t> triangles;  // 3 * T
    MaterialRec material;
    bool default_material = false;
};

struct LoadResult {
    std::vector<SubMeshRec> submeshes;
    std::string error;
};

struct Corner {
    int v = -1, vt = -1, vn = -1;
};

// OBJ face corner "v", "v/vt", "v//vn", "v/vt/vn"; 1-based, negatives
// relative to the current count.
static Corner parseCorner(const char* tok, int nv, int nvt, int nvn)
{
    Corner c;
    int vals[3] = {0, 0, 0};
    bool has[3] = {false, false, false};
    int field = 0;
    int sign = 1;
    int acc = 0;
    bool digits = false;
    for (const char* p = tok;; ++p) {
        char ch = *p;
        if (ch == '-') {
            sign = -1;
        } else if (ch >= '0' && ch <= '9') {
            acc = acc * 10 + (ch - '0');
            digits = true;
        } else if (ch == '/' || ch == '\0') {
            if (digits) {
                vals[field] = sign * acc;
                has[field] = true;
            }
            acc = 0;
            sign = 1;
            digits = false;
            ++field;
            if (ch == '\0' || field >= 3)
                break;
        } else {
            break;  // malformed
        }
    }
    auto fix = [](int idx, int n) { return idx > 0 ? idx - 1 : n + idx; };
    if (has[0]) c.v = fix(vals[0], nv);
    if (has[1]) c.vt = fix(vals[1], nvt);
    if (has[2]) c.vn = fix(vals[2], nvn);
    return c;
}

static void parseMtl(const std::string& path,
                     std::vector<MaterialRec>& materials,
                     std::unordered_map<std::string, int>& index)
{
    std::ifstream f(path);
    if (!f)
        return;
    std::string line;
    MaterialRec* cur = nullptr;
    while (std::getline(f, line)) {
        size_t b = line.find_first_not_of(" \t\r\n");
        if (b == std::string::npos || line[b] == '#')
            continue;
        std::istringstream ss(line.substr(b));
        std::string key;
        ss >> key;
        if (key == "newmtl") {
            std::string name;
            std::getline(ss, name);
            size_t s = name.find_first_not_of(" \t");
            name = s == std::string::npos ? "" : name.substr(s);
            size_t e = name.find_last_not_of(" \t\r");
            if (e != std::string::npos)
                name = name.substr(0, e + 1);
            if (!index.count(name)) {
                index[name] = (int)materials.size();
                materials.emplace_back();
            }
            cur = &materials[index[name]];
        } else if (!cur) {
            continue;
        } else if (key == "Kd") {
            ss >> cur->kd[0] >> cur->kd[1] >> cur->kd[2];
        } else if (key == "Ks") {
            ss >> cur->ks[0] >> cur->ks[1] >> cur->ks[2];
        } else if (key == "Ns") {
            ss >> cur->shininess;
        } else if (key == "d") {
            ss >> cur->dissolve;
        } else if (key == "Tr") {
            float tr = 0;
            ss >> tr;
            cur->dissolve = 1.0f - tr;  // tinyobj: Tr = 1 - d
        } else if (key == "map_Kd") {
            std::string rest;
            std::getline(ss, rest);
            size_t s = rest.find_first_not_of(" \t");
            rest = s == std::string::npos ? "" : rest.substr(s);
            size_t e = rest.find_last_not_of(" \t\r");
            if (e != std::string::npos)
                rest = rest.substr(0, e + 1);
            cur->map_kd = rest;
        }
    }
}

struct VKey {
    float p[8];
    bool operator==(const VKey& o) const
    {
        return std::memcmp(p, o.p, sizeof(p)) == 0;
    }
};
struct VKeyHash {
    size_t operator()(const VKey& k) const
    {
        size_t h = 1469598103934665603ull;
        const unsigned char* b = reinterpret_cast<const unsigned char*>(k.p);
        for (size_t i = 0; i < sizeof(k.p); ++i) {
            h ^= b[i];
            h *= 1099511628211ull;
        }
        return h;
    }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// OBJ loading
// ---------------------------------------------------------------------------

void* cge_load_obj(const char* path_c, int center_and_normalize)
{
    auto* result = new LoadResult();
    std::string path(path_c);
    std::ifstream f(path);
    if (!f) {
        result->error = "File does not exist";
        return result;
    }
    std::string base_dir;
    {
        size_t slash = path.find_last_of('/');
        base_dir = slash == std::string::npos ? "." : path.substr(0, slash);
    }

    std::vector<float> verts, norms, uvs;  // 3/3/2-strided
    std::vector<MaterialRec> materials;
    std::unordered_map<std::string, int> mat_index;

    struct Tri {
        Corner c[3];
        int mat;
    };
    std::vector<std::vector<Tri>> shapes(1);
    int cur_mat = -1;

    std::string line;
    while (std::getline(f, line)) {
        size_t b = line.find_first_not_of(" \t\r\n");
        if (b == std::string::npos || line[b] == '#')
            continue;
        const char* s = line.c_str() + b;
        if (s[0] == 'v' && s[1] == ' ') {
            float x, y, z;
            if (std::sscanf(s + 2, "%f %f %f", &x, &y, &z) == 3) {
                verts.push_back(x);
                verts.push_back(y);
                verts.push_back(z);
            }
        } else if (s[0] == 'v' && s[1] == 'n' && s[2] == ' ') {
            float x, y, z;
            if (std::sscanf(s + 3, "%f %f %f", &x, &y, &z) == 3) {
                norms.push_back(x);
                norms.push_back(y);
                norms.push_back(z);
            }
        } else if (s[0] == 'v' && s[1] == 't' && s[2] == ' ') {
            float u, v;
            if (std::sscanf(s + 3, "%f %f", &u, &v) == 2) {
                uvs.push_back(u);
                uvs.push_back(v);
            }
        } else if (s[0] == 'f' && s[1] == ' ') {
            std::istringstream ss(s + 2);
            std::string tok;
            std::vector<Corner> corners;
            while (ss >> tok)
                corners.push_back(parseCorner(tok.c_str(), (int)verts.size() / 3,
                                              (int)uvs.size() / 2,
                                              (int)norms.size() / 3));
            size_t n = corners.size();
            auto& tris = shapes.back();
            if (n == 3) {
                tris.push_back({{corners[0], corners[1], corners[2]}, cur_mat});
            } else if (n == 4) {
                // tinyobj "simple" triangulation: split the shorter diagonal
                auto at = [&](int ci) {
                    int vi = corners[ci].v;
                    return Vec3{verts[3 * vi], verts[3 * vi + 1], verts[3 * vi + 2]};
                };
                Vec3 d02 = at(2) - at(0), d13 = at(3) - at(1);
                if (dot(d02, d02) < dot(d13, d13)) {
                    tris.push_back({{corners[0], corners[1], corners[2]}, cur_mat});
                    tris.push_back({{corners[0], corners[2], corners[3]}, cur_mat});
                } else {
                    tris.push_back({{corners[0], corners[1], corners[3]}, cur_mat});
                    tris.push_back({{corners[1], corners[2], corners[3]}, cur_mat});
                }
            } else {
                for (size_t i = 1; i + 1 < n; ++i)  // fan
                    tris.push_back({{corners[0], corners[i], corners[i + 1]}, cur_mat});
            }
        } else if ((s[0] == 'o' || s[0] == 'g') && (s[1] == ' ' || s[1] == '\0')) {
            if (!shapes.back().empty())
                shapes.emplace_back();
        } else if (std::strncmp(s, "usemtl", 6) == 0) {
            std::string name(s + 6);
            size_t st = name.find_first_not_of(" \t");
            name = st == std::string::npos ? "" : name.substr(st);
            size_t e = name.find_last_not_of(" \t\r");
            if (e != std::string::npos)
                name = name.substr(0, e + 1);
            auto it = mat_index.find(name);
            cur_mat = it == mat_index.end() ? -1 : it->second;
        } else if (std::strncmp(s, "mtllib", 6) == 0) {
            std::string name(s + 6);
            size_t st = name.find_first_not_of(" \t");
            name = st == std::string::npos ? "" : name.substr(st);
            size_t e = name.find_last_not_of(" \t\r");
            if (e != std::string::npos)
                name = name.substr(0, e + 1);
            parseMtl(base_dir + "/" + name, materials, mat_index);
        }
    }

    // submesh splitting by runs of material id (mesh.cpp:76-142 semantics,
    // incl. the final-triangle merge edge case) + per-submesh vertex dedup
    for (auto& tris : shapes) {
        if (tris.empty())
            continue;
        size_t num = tris.size();
        size_t start = 0, end = 0;
        int prev_mat = tris[0].mat;
        while (end < num) {
            if (end == num - 1) {
                ++end;  // write remaining mesh
            } else if (tris[end].mat == prev_mat) {
                ++end;
                continue;
            } else {
                prev_mat = tris[end].mat;
            }

            SubMeshRec sm;
            std::unordered_map<VKey, uint32_t, VKeyHash> cache;
            cache.reserve((end - start) * 3);
            for (size_t ti = start; ti < end; ++ti) {
                const Tri& t = tris[ti];
                Vec3 p[3];
                for (int k = 0; k < 3; ++k) {
                    int vi = t.c[k].v;
                    p[k] = {verts[3 * vi], verts[3 * vi + 1], verts[3 * vi + 2]};
                }
                Vec3 gn = cross(p[1] - p[0], p[2] - p[0]);
                float gl = len(gn);
                if (gl > 0) {
                    gn = {gn.x / gl, gn.y / gl, gn.z / gl};
                }
                for (int k = 0; k < 3; ++k) {
                    const Corner& c = t.c[k];
                    Vec3 nrm = gn;
                    if (c.vn >= 0 && !norms.empty())
                        nrm = {norms[3 * c.vn], norms[3 * c.vn + 1], norms[3 * c.vn + 2]};
                    float u = 0, v = 0;
                    if (c.vt >= 0 && !uvs.empty()) {
                        u = uvs[2 * c.vt];
                        v = uvs[2 * c.vt + 1];
                    }
                    VKey key = {{p[k].x, p[k].y, p[k].z, nrm.x, nrm.y, nrm.z, u, v}};
                    auto it = cache.find(key);
                    uint32_t idx;
                    if (it == cache.end()) {
                        idx = (uint32_t)(sm.positions.size() / 3);
                        cache.emplace(key, idx);
                        sm.positions.insert(sm.positions.end(), {p[k].x, p[k].y, p[k].z});
                        sm.normals.insert(sm.normals.end(), {nrm.x, nrm.y, nrm.z});
                        sm.texcoords.insert(sm.texcoords.end(), {u, v});
                    } else {
                        idx = it->second;
                    }
                    sm.triangles.push_back(idx);
                }
            }
            int mid = tris[start].mat;
            if (mid < 0) {
                sm.default_material = true;
                sm.material.kd[0] = sm.material.kd[1] = sm.material.kd[2] = 1.0f;
            } else {
                sm.material = materials[mid];
            }
            result->submeshes.push_back(std::move(sm));
            start = end;
            ++end;
        }
    }

    if (center_and_normalize && !result->submeshes.empty()) {
        // centerAndScaleToUnitMesh (mesh.cpp:151-176): f32 accumulation
        float cx = 0, cy = 0, cz = 0;
        size_t n = 0;
        for (auto& sm : result->submeshes)
            for (size_t i = 0; i < sm.positions.size(); i += 3) {
                cx += sm.positions[i];
                cy += sm.positions[i + 1];
                cz += sm.positions[i + 2];
                ++n;
            }
        cx /= (float)n;
        cy /= (float)n;
        cz /= (float)n;
        float maxd = 0;
        for (auto& sm : result->submeshes)
            for (size_t i = 0; i < sm.positions.size(); i += 3) {
                float dx = sm.positions[i] - cx, dy = sm.positions[i + 1] - cy,
                      dz = sm.positions[i + 2] - cz;
                maxd = std::max(maxd, std::sqrt(dx * dx + dy * dy + dz * dz));
            }
        for (auto& sm : result->submeshes)
            for (size_t i = 0; i < sm.positions.size(); i += 3) {
                sm.positions[i] = (sm.positions[i] - cx) / maxd;
                sm.positions[i + 1] = (sm.positions[i + 1] - cy) / maxd;
                sm.positions[i + 2] = (sm.positions[i + 2] - cz) / maxd;
            }
    }
    return result;
}

const char* cge_error(void* h) { return static_cast<LoadResult*>(h)->error.c_str(); }

int cge_n_submeshes(void* h)
{
    return (int)static_cast<LoadResult*>(h)->submeshes.size();
}

void cge_submesh_counts(void* h, int i, int* n_verts, int* n_tris)
{
    auto& sm = static_cast<LoadResult*>(h)->submeshes[i];
    *n_verts = (int)(sm.positions.size() / 3);
    *n_tris = (int)(sm.triangles.size() / 3);
}

void cge_submesh_data(void* h, int i, float* pos, float* nrm, float* uv,
                      uint32_t* tris)
{
    auto& sm = static_cast<LoadResult*>(h)->submeshes[i];
    std::memcpy(pos, sm.positions.data(), sm.positions.size() * sizeof(float));
    std::memcpy(nrm, sm.normals.data(), sm.normals.size() * sizeof(float));
    std::memcpy(uv, sm.texcoords.data(), sm.texcoords.size() * sizeof(float));
    std::memcpy(tris, sm.triangles.data(), sm.triangles.size() * sizeof(uint32_t));
}

// out8: kd[3], ks[3], shininess, dissolve. Returns 1 if default material.
int cge_submesh_material(void* h, int i, float* out8, char* map_kd, int cap)
{
    auto& sm = static_cast<LoadResult*>(h)->submeshes[i];
    out8[0] = sm.material.kd[0];
    out8[1] = sm.material.kd[1];
    out8[2] = sm.material.kd[2];
    out8[3] = sm.material.ks[0];
    out8[4] = sm.material.ks[1];
    out8[5] = sm.material.ks[2];
    out8[6] = sm.material.shininess;
    out8[7] = sm.material.dissolve;
    std::snprintf(map_kd, cap, "%s", sm.material.map_kd.c_str());
    return sm.default_material ? 1 : 0;
}

void cge_release(void* h) { delete static_cast<LoadResult*>(h); }

// ---------------------------------------------------------------------------
// Cluster builder (cge_tpu_torch.ops.bvh.build_clusters semantics): largest-extent
// median splits down to <= cluster_size, children adjacent in cluster order.
// perm_out: caller-allocated [capacity]; returns the number of clusters, or
// -1 if capacity is insufficient. Each cluster occupies cluster_size slots,
// -1 padded.
// ---------------------------------------------------------------------------

static void clusterRec(const float* centers, std::vector<int>& ids, int lo,
                       int hi, int cluster_size, std::vector<int>& out)
{
    int n = hi - lo;
    if (n <= cluster_size) {
        for (int i = lo; i < hi; ++i)
            out.push_back(ids[i]);
        for (int i = n; i < cluster_size; ++i)
            out.push_back(-1);
        return;
    }
    float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = lo; i < hi; ++i)
        for (int a = 0; a < 3; ++a) {
            float v = centers[3 * ids[i] + a];
            mn[a] = std::min(mn[a], v);
            mx[a] = std::max(mx[a], v);
        }
    int axis = 0;
    float best = mx[0] - mn[0];
    for (int a = 1; a < 3; ++a)
        if (mx[a] - mn[a] > best) {
            best = mx[a] - mn[a];
            axis = a;
        }
    // split at the cluster-size multiple nearest the median so every left
    // descendant fills its cluster completely: a pure median split leaves
    // every cluster at n / 2^ceil(log2(n/cs)) occupancy (59% on the 614k
    // dragon — 41% of all dense-tile intersection work spent on pad rows,
    // measured on the JAX package). Nudging the split by < cluster_size keeps the spatial
    // partition essentially identical.
    int half = n / 2;
    int mid_off = (half + cluster_size / 2) / cluster_size * cluster_size;
    if (mid_off < cluster_size)
        mid_off = cluster_size;
    int max_off = (n - 1) / cluster_size * cluster_size;
    if (mid_off > max_off)
        mid_off = max_off;
    int mid = lo + mid_off;
    std::nth_element(ids.begin() + lo, ids.begin() + mid, ids.begin() + hi,
                     [&](int a, int b) {
                         return centers[3 * a + axis] < centers[3 * b + axis];
                     });
    clusterRec(centers, ids, lo, mid, cluster_size, out);
    clusterRec(centers, ids, mid, hi, cluster_size, out);
}

int cge_build_clusters(const float* centers, int n, int cluster_size,
                       int* perm_out, int capacity)
{
    if (n <= 0) {
        if (capacity < cluster_size)
            return -1;
        for (int i = 0; i < cluster_size; ++i)
            perm_out[i] = -1;
        return 1;
    }
    std::vector<int> ids(n);
    std::iota(ids.begin(), ids.end(), 0);
    std::vector<int> out;
    out.reserve(((size_t)n / cluster_size + 2) * cluster_size);
    clusterRec(centers, ids, 0, n, cluster_size, out);
    if ((int)out.size() > capacity)
        return -1;
    std::memcpy(perm_out, out.data(), out.size() * sizeof(int));
    return (int)(out.size() / cluster_size);
}

// ---------------------------------------------------------------------------
// Reference-parity BVH builder (bounding_volume_hierarchy.cpp:74-194).
// Inputs: per-primitive AABBs + centers. Outputs linearized nodes in the
// same order the recursive build emits them (children before parents) and
// the primitive permutation. node_meta rows: is_leaf, depth, beg, end, l, r.
// Returns the node count (root = count - 1), or -1 on insufficient capacity
// (capacity must be >= 2n - 1 rows).
// ---------------------------------------------------------------------------

namespace {

struct BvhBuild {
    const float* lo;
    const float* hi;
    const float* centers;
    bool sah;
    std::vector<int> order;
    float* node_lo;
    float* node_hi;
    int32_t* node_meta;
    int count = 0;
    int max_leaf = 0;
    int leaves = 0;
    int levels = 0;

    void bbox(int beg, int end, float* blo, float* bhi) const
    {
        for (int a = 0; a < 3; ++a) {
            blo[a] = 1e30f;
            bhi[a] = -1e30f;
        }
        for (int i = beg; i < end; ++i)
            for (int a = 0; a < 3; ++a) {
                blo[a] = std::min(blo[a], lo[3 * order[i] + a]);
                bhi[a] = std::max(bhi[a], hi[3 * order[i] + a]);
            }
    }

    static float area(const float* blo, const float* bhi)
    {
        float e0 = bhi[0] - blo[0], e1 = bhi[1] - blo[1], e2 = bhi[2] - blo[2];
        return 2.0f * (e0 * e1 + e1 * e2 + e2 * e0);
    }

    int splitStandard(int beg, int end, int depth)
    {
        int axis = depth % 3;
        int mid = beg + (end - beg) / 2;
        std::nth_element(order.begin() + beg, order.begin() + mid,
                         order.begin() + end, [&](int a, int b) {
                             return centers[3 * a + axis] < centers[3 * b + axis];
                         });
        return mid;
    }

    int splitSah(int beg, int end, int /*depth*/)
    {
        const int NUM_OF_BINS = 8;
        int n = end - beg;
        int skip = std::max(1, n / NUM_OF_BINS);
        double best_cost = 1e300;
        int best_split = -1, best_axis = -1;
        std::vector<float> pre_area(n), suf_area(n);
        for (int axis = 0; axis < 3; ++axis) {
            std::stable_sort(order.begin() + beg, order.begin() + end,
                             [&](int a, int b) {
                                 return centers[3 * a + axis] < centers[3 * b + axis];
                             });
            float blo[3] = {1e30f, 1e30f, 1e30f}, bhi[3] = {-1e30f, -1e30f, -1e30f};
            for (int i = 0; i < n; ++i) {
                for (int a = 0; a < 3; ++a) {
                    blo[a] = std::min(blo[a], lo[3 * order[beg + i] + a]);
                    bhi[a] = std::max(bhi[a], hi[3 * order[beg + i] + a]);
                }
                pre_area[i] = area(blo, bhi);
            }
            for (int a = 0; a < 3; ++a) {
                blo[a] = 1e30f;
                bhi[a] = -1e30f;
            }
            for (int i = n - 1; i >= 0; --i) {
                for (int a = 0; a < 3; ++a) {
                    blo[a] = std::min(blo[a], lo[3 * order[beg + i] + a]);
                    bhi[a] = std::max(bhi[a], hi[3 * order[beg + i] + a]);
                }
                suf_area[i] = area(blo, bhi);
            }
            for (int split = beg + skip; split < end; split += skip) {
                int k = split - beg;
                double cost = (double)pre_area[k - 1] * k
                    + (double)suf_area[k] * (end - split);
                if (cost < best_cost) {
                    best_cost = cost;
                    best_split = split;
                    best_axis = axis;
                }
            }
        }
        std::stable_sort(order.begin() + beg, order.begin() + end,
                         [&](int a, int b) {
                             return centers[3 * a + best_axis] < centers[3 * b + best_axis];
                         });
        return best_split;
    }

    int create(int beg, int end, int depth)
    {
        levels = std::max(levels, depth + 1);
        float blo[3], bhi[3];
        bbox(beg, end, blo, bhi);
        const int MAX_DEPTH = 16;
        if (depth + 1 == MAX_DEPTH || beg + 1 == end) {
            int id = count++;
            std::memcpy(node_lo + 3 * id, blo, 12);
            std::memcpy(node_hi + 3 * id, bhi, 12);
            int32_t* m = node_meta + 6 * id;
            m[0] = 1;
            m[1] = depth;
            m[2] = beg;
            m[3] = end;
            m[4] = -1;
            m[5] = -1;
            ++leaves;
            max_leaf = std::max(max_leaf, end - beg);
            return id;
        }
        int mid = sah ? splitSah(beg, end, depth) : splitStandard(beg, end, depth);
        int left = create(beg, mid, depth + 1);
        int right = create(mid, end, depth + 1);
        int id = count++;
        std::memcpy(node_lo + 3 * id, blo, 12);
        std::memcpy(node_hi + 3 * id, bhi, 12);
        int32_t* m = node_meta + 6 * id;
        m[0] = 0;
        m[1] = depth;
        m[2] = beg;
        m[3] = end;
        m[4] = left;
        m[5] = right;
        return id;
    }
};

}  // namespace

// stats_out: levels, leaves, max_per_leaf.
int cge_build_bvh(const float* lo, const float* hi, const float* centers,
                  int n, int sah, int capacity, float* node_lo,
                  float* node_hi, int32_t* node_meta, int32_t* perm_out,
                  int32_t* stats_out)
{
    if (n <= 0 || capacity < 2 * n - 1)
        return -1;
    BvhBuild b;
    b.lo = lo;
    b.hi = hi;
    b.centers = centers;
    b.sah = sah != 0;
    b.order.resize(n);
    std::iota(b.order.begin(), b.order.end(), 0);
    b.node_lo = node_lo;
    b.node_hi = node_hi;
    b.node_meta = node_meta;
    b.create(0, n, 0);
    for (int i = 0; i < n; ++i)
        perm_out[i] = b.order[i];
    stats_out[0] = b.levels;
    stats_out[1] = b.leaves;
    stats_out[2] = b.max_leaf;
    return b.count;
}

}  // extern "C"
