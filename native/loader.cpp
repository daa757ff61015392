// Native data-loader fast path for saccot.
//
// The reference's I/O layer is C++ (PCL readers; SURVEY.md section 2.1
// "Cloud I/O"); this is the framework's native equivalent for the
// formats where parsing cost actually matters at sweep scale: KITTI
// velodyne .bin scans (~100k points / 1.6 MB each, thousands per
// sequence), binary PLY, and the host-side voxel-grid downsample that
// feeds fixed-size buckets to the device. Exposed as a plain C ABI and
// loaded from Python with ctypes (saccot/io/native.py); every entry
// point has a NumPy fallback so the framework runs without the .so.
//
// Build: native/build.sh (g++ -O3 -shared).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// KITTI velodyne: packed float32 x,y,z,reflectance records.
// Writes up to max_pts*3 floats into out; returns point count or -1.
long saccot_load_kitti_bin(const char* path, float* out, long max_pts) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long bytes = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    long n = bytes / (4 * sizeof(float));
    if (n > max_pts) n = max_pts;
    std::vector<float> buf(static_cast<size_t>(n) * 4);
    size_t got = std::fread(buf.data(), sizeof(float), buf.size(), f);
    std::fclose(f);
    n = static_cast<long>(got / 4);
    for (long i = 0; i < n; ++i) {
        out[i * 3 + 0] = buf[i * 4 + 0];
        out[i * 3 + 1] = buf[i * 4 + 1];
        out[i * 3 + 2] = buf[i * 4 + 2];
    }
    return n;
}

// Binary little-endian PLY with float x,y,z as the first three vertex
// properties (the overwhelmingly common layout). Returns count or -1.
long saccot_load_ply_xyz(const char* path, float* out, long max_pts) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    char line[4096];
    long n_vertex = -1;
    int vertex_stride = 0;   // bytes per vertex record
    int n_props_before = 0;  // float props seen before x (none expected)
    bool binary_le = false;
    bool in_vertex = false;
    bool seen_xyz[3] = {false, false, false};
    static const int type_size_count = 10;
    static const char* type_names[type_size_count] = {
        "char", "uchar", "int8", "uint8", "short", "ushort",
        "int", "uint", "float", "double"};
    static const int type_sizes[type_size_count] = {1, 1, 1, 1, 2, 2, 4, 4, 4, 8};

    while (std::fgets(line, sizeof line, f)) {
        if (std::strncmp(line, "format", 6) == 0) {
            binary_le = std::strstr(line, "binary_little_endian") != nullptr;
        } else if (std::strncmp(line, "element vertex", 14) == 0) {
            n_vertex = std::strtol(line + 14, nullptr, 10);
            in_vertex = true;
        } else if (std::strncmp(line, "element", 7) == 0) {
            in_vertex = false;
        } else if (in_vertex && std::strncmp(line, "property", 8) == 0) {
            char type[64], name[64];
            if (std::sscanf(line, "property %63s %63s", type, name) == 2) {
                if (std::strcmp(type, "list") == 0) { std::fclose(f); return -1; }
                int sz = 0;
                for (int t = 0; t < type_size_count; ++t)
                    if (std::strcmp(type, type_names[t]) == 0) sz = type_sizes[t];
                if (sz == 0) { std::fclose(f); return -1; }
                if (std::strcmp(name, "x") == 0) seen_xyz[0] = true;
                if (std::strcmp(name, "y") == 0) seen_xyz[1] = true;
                if (std::strcmp(name, "z") == 0) seen_xyz[2] = true;
                if (!seen_xyz[0]) n_props_before += sz;
                vertex_stride += sz;
            }
        } else if (std::strncmp(line, "end_header", 10) == 0) {
            break;
        }
    }
    if (!binary_le || n_vertex < 0 || !(seen_xyz[0] && seen_xyz[1] && seen_xyz[2])) {
        std::fclose(f);
        return -1;
    }
    long n = n_vertex < max_pts ? n_vertex : max_pts;
    std::vector<char> rec(static_cast<size_t>(vertex_stride));
    for (long i = 0; i < n; ++i) {
        if (std::fread(rec.data(), 1, rec.size(), f) != rec.size()) { n = i; break; }
        std::memcpy(&out[i * 3], rec.data() + n_props_before, 3 * sizeof(float));
    }
    std::fclose(f);
    return n;
}

// Hash-grid voxel downsample: per-voxel centroid, first-come voxel order.
// Returns number of output points (<= max_out).
long saccot_voxel_downsample(const float* pts, long n, float voxel,
                             float* out, long max_out) {
    struct Acc { double x = 0, y = 0, z = 0; long c = 0; };
    std::unordered_map<uint64_t, Acc> grid;
    grid.reserve(static_cast<size_t>(n < max_out ? n : max_out) * 2);
    std::vector<uint64_t> order;
    order.reserve(static_cast<size_t>(max_out));
    const double inv = 1.0 / voxel;
    for (long i = 0; i < n; ++i) {
        // 21-bit signed coordinates per axis (+-1e6 voxels) packed into 63 bits.
        int64_t ix = static_cast<int64_t>(std::floor(pts[i * 3 + 0] * inv)) + (1 << 20);
        int64_t iy = static_cast<int64_t>(std::floor(pts[i * 3 + 1] * inv)) + (1 << 20);
        int64_t iz = static_cast<int64_t>(std::floor(pts[i * 3 + 2] * inv)) + (1 << 20);
        if ((ix | iy | iz) & ~((1 << 21) - 1)) continue;  // out of range
        uint64_t key = (static_cast<uint64_t>(ix) << 42) |
                       (static_cast<uint64_t>(iy) << 21) |
                       static_cast<uint64_t>(iz);
        auto it = grid.find(key);
        if (it == grid.end()) {
            if (static_cast<long>(order.size()) >= max_out) continue;
            it = grid.emplace(key, Acc{}).first;
            order.push_back(key);
        }
        it->second.x += pts[i * 3 + 0];
        it->second.y += pts[i * 3 + 1];
        it->second.z += pts[i * 3 + 2];
        it->second.c += 1;
    }
    long m = static_cast<long>(order.size());
    for (long i = 0; i < m; ++i) {
        const Acc& a = grid[order[i]];
        out[i * 3 + 0] = static_cast<float>(a.x / a.c);
        out[i * 3 + 1] = static_cast<float>(a.y / a.c);
        out[i * 3 + 2] = static_cast<float>(a.z / a.c);
    }
    return m;
}

}  // extern "C"
