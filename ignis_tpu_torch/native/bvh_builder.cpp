// Native binned-SAH BVH8 builder.
//
// C++ analog of bvh/builder.py (which mirrors the reference's
// madmann91/bvh build + N-ary collapse, SceneBVHAdapter.h / NArityBvh.h)
// for large scenes where the numpy builder dominates load time. The output
// layout is identical: SoA child bounds [n_nodes][8], child references
// (0 empty, >0 inner, <0 leaf encoding -((start<<4|count)+1)), and a
// primitive permutation so leaves are contiguous ranges.
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int LEAF_SIZE = 4;
constexpr int N_BINS = 16;
constexpr int WIDTH = 8;

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b)
{
    return { std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z) };
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b)
{
    return { std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z) };
}
static inline float half_area(const Vec3& mn, const Vec3& mx)
{
    float dx = std::max(mx.x - mn.x, 0.f);
    float dy = std::max(mx.y - mn.y, 0.f);
    float dz = std::max(mx.z - mn.z, 0.f);
    return dx * (dy + dz) + dy * dz;
}

struct BuildNode {
    Vec3 bb_min, bb_max;
    int left = -1, right = -1;  // indices into the node pool
    int start = 0, count = 0;   // leaf range into the index array
    bool is_leaf() const { return left < 0; }
};

struct Builder {
    const Vec3* bmin;
    const Vec3* bmax;
    std::vector<Vec3> centers;
    std::vector<int> indices;       // permuted during the build
    std::vector<BuildNode> pool;

    int build(int begin, int end)
    {
        int my = (int)pool.size();
        pool.emplace_back();
        Vec3 nb_min = { std::numeric_limits<float>::infinity(),
                        std::numeric_limits<float>::infinity(),
                        std::numeric_limits<float>::infinity() };
        Vec3 nb_max = { -nb_min.x, -nb_min.y, -nb_min.z };
        Vec3 c_min = nb_min, c_max = nb_max;
        for (int i = begin; i < end; ++i) {
            nb_min = vmin(nb_min, bmin[indices[i]]);
            nb_max = vmax(nb_max, bmax[indices[i]]);
            c_min = vmin(c_min, centers[indices[i]]);
            c_max = vmax(c_max, centers[indices[i]]);
        }
        pool[my].bb_min = nb_min;
        pool[my].bb_max = nb_max;
        int n = end - begin;
        if (n <= LEAF_SIZE) {
            pool[my].start = begin;
            pool[my].count = n;
            return my;
        }

        float ext[3] = { c_max.x - c_min.x, c_max.y - c_min.y,
                         c_max.z - c_min.z };
        int axis = 0;
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int mid = -1;
        if (ext[axis] >= 1e-12f) {
            float lo = axis == 0 ? c_min.x : (axis == 1 ? c_min.y : c_min.z);
            float scale = N_BINS * (1.0f - 1e-6f) / std::max(ext[axis], 1e-30f);
            auto bin_of = [&](int prim) {
                const Vec3& c = centers[prim];
                float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
                int b = (int)((v - lo) * scale);
                return std::min(std::max(b, 0), N_BINS - 1);
            };
            int counts[N_BINS] = {};
            Vec3 bmn[N_BINS], bmx[N_BINS];
            for (int b = 0; b < N_BINS; ++b) {
                bmn[b] = { std::numeric_limits<float>::infinity(),
                           std::numeric_limits<float>::infinity(),
                           std::numeric_limits<float>::infinity() };
                bmx[b] = { -bmn[b].x, -bmn[b].y, -bmn[b].z };
            }
            for (int i = begin; i < end; ++i) {
                int b = bin_of(indices[i]);
                counts[b]++;
                bmn[b] = vmin(bmn[b], bmin[indices[i]]);
                bmx[b] = vmax(bmx[b], bmax[indices[i]]);
            }
            // prefix/suffix sweep
            Vec3 lmn[N_BINS], lmx[N_BINS], rmn[N_BINS], rmx[N_BINS];
            Vec3 acc_mn = bmn[0], acc_mx = bmx[0];
            for (int b = 0; b < N_BINS; ++b) {
                if (b) { acc_mn = vmin(acc_mn, bmn[b]); acc_mx = vmax(acc_mx, bmx[b]); }
                lmn[b] = acc_mn; lmx[b] = acc_mx;
            }
            acc_mn = bmn[N_BINS - 1]; acc_mx = bmx[N_BINS - 1];
            for (int b = N_BINS - 1; b >= 0; --b) {
                if (b < N_BINS - 1) { acc_mn = vmin(acc_mn, bmn[b]); acc_mx = vmax(acc_mx, bmx[b]); }
                rmn[b] = acc_mn; rmx[b] = acc_mx;
            }
            int lcount = 0;
            float best_cost = std::numeric_limits<float>::infinity();
            int best_split = -1;
            for (int split = 1; split < N_BINS; ++split) {
                lcount += counts[split - 1];
                int rcount = n - lcount;
                if (lcount == 0 || rcount == 0) continue;
                float cost = lcount * half_area(lmn[split - 1], lmx[split - 1])
                    + rcount * half_area(rmn[split], rmx[split]);
                if (cost < best_cost) { best_cost = cost; best_split = split; }
            }
            if (best_split >= 0) {
                auto it = std::partition(
                    indices.begin() + begin, indices.begin() + end,
                    [&](int prim) { return bin_of(prim) < best_split; });
                mid = (int)(it - indices.begin());
                if (mid == begin || mid == end) mid = -1;
            }
        }
        if (mid < 0) {  // degenerate: median split on the axis
            mid = begin + n / 2;
            std::nth_element(
                indices.begin() + begin, indices.begin() + mid,
                indices.begin() + end, [&](int a, int b) {
                    const Vec3& ca = centers[a];
                    const Vec3& cb = centers[b];
                    float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                    float vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
                    return va < vb;
                });
        }
        int l = build(begin, mid);
        int r = build(mid, end);
        pool[my].left = l;
        pool[my].right = r;
        return my;
    }
};

struct Emitter {
    const Builder* b;
    float* cmin_x; float* cmin_y; float* cmin_z;
    float* cmax_x; float* cmax_y; float* cmax_z;
    int32_t* child;
    int32_t* prim_order;
    int cap_nodes;
    int n_nodes = 0;
    int n_prims = 0;
    bool overflow = false;

    static int encode_leaf(int start, int count)
    {
        return -((start << 4 | count) + 1);
    }

    int emit(int node_idx)
    {
        if (n_nodes >= cap_nodes) { overflow = true; return 0; }
        int my = n_nodes++;
        // greedy wide collapse: split the largest-area inner subtree
        int subtrees[2 * WIDTH];
        int n_sub = 1;
        subtrees[0] = node_idx;
        while (n_sub < WIDTH) {
            int pick = -1;
            float best = -1.f;
            for (int i = 0; i < n_sub; ++i) {
                const BuildNode& s = b->pool[subtrees[i]];
                if (s.is_leaf()) continue;
                float a = half_area(s.bb_min, s.bb_max);
                if (a > best) { best = a; pick = i; }
            }
            if (pick < 0) break;
            int node = subtrees[pick];
            subtrees[pick] = subtrees[n_sub - 1];
            --n_sub;
            subtrees[n_sub++] = b->pool[node].left;
            subtrees[n_sub++] = b->pool[node].right;
        }
        for (int j = 0; j < WIDTH; ++j) {
            int off = my * WIDTH + j;
            if (j >= n_sub) {
                cmin_x[off] = cmin_y[off] = cmin_z[off] =
                    std::numeric_limits<float>::infinity();
                cmax_x[off] = cmax_y[off] = cmax_z[off] =
                    -std::numeric_limits<float>::infinity();
                child[off] = 0;
                continue;
            }
            const BuildNode& ch = b->pool[subtrees[j]];
            cmin_x[off] = ch.bb_min.x; cmin_y[off] = ch.bb_min.y;
            cmin_z[off] = ch.bb_min.z;
            cmax_x[off] = ch.bb_max.x; cmax_y[off] = ch.bb_max.y;
            cmax_z[off] = ch.bb_max.z;
            if (ch.is_leaf()) {
                int start = n_prims;
                for (int k = 0; k < ch.count; ++k)
                    prim_order[n_prims++] = b->indices[ch.start + k];
                child[off] = encode_leaf(start, ch.count);
            } else {
                child[off] = emit(subtrees[j]);
            }
        }
        return my;
    }
};

}  // namespace

extern "C" {

// Returns the number of emitted BVH8 nodes, or -1 on capacity overflow.
int ig_build_bvh8(const float* tri_bb_min, const float* tri_bb_max,
                  int n_tris,
                  float* cmin_x, float* cmin_y, float* cmin_z,
                  float* cmax_x, float* cmax_y, float* cmax_z,
                  int32_t* child, int32_t* prim_order, int cap_nodes)
{
    if (n_tris <= 0)
        return 0;
    Builder b;
    b.bmin = reinterpret_cast<const Vec3*>(tri_bb_min);
    b.bmax = reinterpret_cast<const Vec3*>(tri_bb_max);
    b.centers.resize(n_tris);
    b.indices.resize(n_tris);
    for (int i = 0; i < n_tris; ++i) {
        b.centers[i] = { (b.bmin[i].x + b.bmax[i].x) * 0.5f,
                         (b.bmin[i].y + b.bmax[i].y) * 0.5f,
                         (b.bmin[i].z + b.bmax[i].z) * 0.5f };
        b.indices[i] = i;
    }
    b.pool.reserve((size_t)n_tris * 2 / LEAF_SIZE + 8);
    int root = b.build(0, n_tris);

    Emitter e;
    e.b = &b;
    e.cmin_x = cmin_x; e.cmin_y = cmin_y; e.cmin_z = cmin_z;
    e.cmax_x = cmax_x; e.cmax_y = cmax_y; e.cmax_z = cmax_z;
    e.child = child;
    e.prim_order = prim_order;
    e.cap_nodes = cap_nodes;

    if (b.pool[root].is_leaf()) {
        // single-leaf scene: one node with one leaf child
        const BuildNode& r = b.pool[root];
        for (int j = 0; j < WIDTH; ++j) {
            cmin_x[j] = cmin_y[j] = cmin_z[j] =
                std::numeric_limits<float>::infinity();
            cmax_x[j] = cmax_y[j] = cmax_z[j] =
                -std::numeric_limits<float>::infinity();
            child[j] = 0;
        }
        cmin_x[0] = r.bb_min.x; cmin_y[0] = r.bb_min.y; cmin_z[0] = r.bb_min.z;
        cmax_x[0] = r.bb_max.x; cmax_y[0] = r.bb_max.y; cmax_z[0] = r.bb_max.z;
        for (int k = 0; k < r.count; ++k)
            prim_order[k] = b.indices[k];
        child[0] = Emitter::encode_leaf(0, r.count);
        return 1;
    }

    e.emit(root);
    return e.overflow ? -1 : e.n_nodes;
}

}  // extern "C"
