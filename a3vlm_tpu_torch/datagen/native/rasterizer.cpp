// Software triangle rasterizer for the datagen render pipeline — the native
// replacement for the reference's pyrender/OpenGL-EGL renderer
// (render_tools.py:184-257). Z-buffered, perspective-correct, producing the
// depth map, per-pixel face id, and per-pixel link id in one pass.
//
// Conventions (must match point_render.py's unprojection):
//   camera looks along -Z (OpenGL style, like pyrender);
//   px = fx * X/|Z| + cx;  py = -fy * Y/|Z| + cy;  depth = |Z|.
//
// Build: g++ -O3 -march=native -shared -fPIC rasterizer.cpp -o librasterizer.so

#include <cmath>
#include <cstdint>
#include <algorithm>
#include <limits>

extern "C" {

// vertices: [n_vertices, 3] CAMERA-space floats.
// faces: [n_faces, 3] int32 vertex indices.
// face_ids: [n_faces] int32 payload written to id_out (e.g. link index).
// depth_out: [h*w] float32, 0 where empty.
// face_out:  [h*w] int32 triangle index, -1 where empty.
// id_out:    [h*w] int32 payload id, -1 where empty.
void rasterize(const float* vertices, int n_vertices,
               const int32_t* faces, const int32_t* face_ids, int n_faces,
               float fx, float fy, float cx, float cy,
               int width, int height,
               float* depth_out, int32_t* face_out, int32_t* id_out) {
    const float INF = std::numeric_limits<float>::infinity();
    // z-buffer initialised to +inf
    float* zbuf = new float[(size_t)width * height];
    for (size_t i = 0; i < (size_t)width * height; ++i) {
        zbuf[i] = INF;
        depth_out[i] = 0.0f;
        face_out[i] = -1;
        id_out[i] = -1;
    }

    // project all vertices once
    float* px = new float[n_vertices];
    float* py = new float[n_vertices];
    float* pz = new float[n_vertices];  // |Z| (camera depth), <=0 invalid
    for (int i = 0; i < n_vertices; ++i) {
        float X = vertices[3 * i + 0];
        float Y = vertices[3 * i + 1];
        float Z = vertices[3 * i + 2];
        float d = -Z;  // camera looks along -Z; visible points have Z < 0
        pz[i] = d;
        if (d > 1e-9f) {
            px[i] = fx * (X / d) + cx;
            py[i] = -fy * (Y / d) + cy;
        } else {
            px[i] = -1e9f;
            py[i] = -1e9f;
        }
    }

    for (int t = 0; t < n_faces; ++t) {
        int i0 = faces[3 * t + 0], i1 = faces[3 * t + 1], i2 = faces[3 * t + 2];
        float z0 = pz[i0], z1 = pz[i1], z2 = pz[i2];
        // cull triangles with any vertex behind the camera (no clipping —
        // fine for object-centric scenes where the camera is outside)
        if (z0 <= 1e-9f || z1 <= 1e-9f || z2 <= 1e-9f) continue;
        float x0 = px[i0], y0 = py[i0];
        float x1 = px[i1], y1 = py[i1];
        float x2 = px[i2], y2 = py[i2];

        float minx = std::min({x0, x1, x2});
        float maxx = std::max({x0, x1, x2});
        float miny = std::min({y0, y1, y2});
        float maxy = std::max({y0, y1, y2});
        int x_lo = std::max(0, (int)std::floor(minx));
        int x_hi = std::min(width - 1, (int)std::ceil(maxx));
        int y_lo = std::max(0, (int)std::floor(miny));
        int y_hi = std::min(height - 1, (int)std::ceil(maxy));
        if (x_lo > x_hi || y_lo > y_hi) continue;

        float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
        if (std::fabs(area) < 1e-12f) continue;
        float inv_area = 1.0f / area;
        float iz0 = 1.0f / z0, iz1 = 1.0f / z1, iz2 = 1.0f / z2;
        int32_t fid = face_ids ? face_ids[t] : t;

        for (int yy = y_lo; yy <= y_hi; ++yy) {
            float pyc = yy + 0.5f;
            for (int xx = x_lo; xx <= x_hi; ++xx) {
                float pxc = xx + 0.5f;
                float w0 = ((x1 - pxc) * (y2 - pyc) - (x2 - pxc) * (y1 - pyc)) * inv_area;
                float w1 = ((x2 - pxc) * (y0 - pyc) - (x0 - pxc) * (y2 - pyc)) * inv_area;
                float w2 = 1.0f - w0 - w1;
                // inside test robust to either winding (area sign folded in)
                if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
                float iz = w0 * iz0 + w1 * iz1 + w2 * iz2;
                float z = 1.0f / iz;
                size_t idx = (size_t)yy * width + xx;
                if (z < zbuf[idx]) {
                    zbuf[idx] = z;
                    depth_out[idx] = z;
                    face_out[idx] = t;
                    id_out[idx] = fid;
                }
            }
        }
    }
    delete[] zbuf;
    delete[] px;
    delete[] py;
    delete[] pz;
}

// Textured variant: additionally interpolates per-face-corner texcoords
// (perspective-correct: u/z, v/z, 1/z) into uv_out [h*w*2]. The visual pass
// samples map_Kd textures from this buffer (the reference's pyrender
// textured render, render_tools.py:166-185).
//
// face_uvs: [n_faces, 3, 2] float32 texcoords per triangle corner.
void rasterize_uv(const float* vertices, int n_vertices,
                  const int32_t* faces, const int32_t* face_ids,
                  const float* face_uvs, int n_faces,
                  float fx, float fy, float cx, float cy,
                  int width, int height,
                  float* depth_out, int32_t* face_out, int32_t* id_out,
                  float* uv_out) {
    const float INF = std::numeric_limits<float>::infinity();
    float* zbuf = new float[(size_t)width * height];
    for (size_t i = 0; i < (size_t)width * height; ++i) {
        zbuf[i] = INF;
        depth_out[i] = 0.0f;
        face_out[i] = -1;
        id_out[i] = -1;
        uv_out[2 * i] = 0.0f;
        uv_out[2 * i + 1] = 0.0f;
    }

    float* px = new float[n_vertices];
    float* py = new float[n_vertices];
    float* pz = new float[n_vertices];
    for (int i = 0; i < n_vertices; ++i) {
        float X = vertices[3 * i + 0];
        float Y = vertices[3 * i + 1];
        float Z = vertices[3 * i + 2];
        float d = -Z;
        pz[i] = d;
        if (d > 1e-9f) {
            px[i] = fx * (X / d) + cx;
            py[i] = -fy * (Y / d) + cy;
        } else {
            px[i] = -1e9f;
            py[i] = -1e9f;
        }
    }

    for (int t = 0; t < n_faces; ++t) {
        int i0 = faces[3 * t + 0], i1 = faces[3 * t + 1], i2 = faces[3 * t + 2];
        float z0 = pz[i0], z1 = pz[i1], z2 = pz[i2];
        if (z0 <= 1e-9f || z1 <= 1e-9f || z2 <= 1e-9f) continue;
        float x0 = px[i0], y0 = py[i0];
        float x1 = px[i1], y1 = py[i1];
        float x2 = px[i2], y2 = py[i2];

        float minx = std::min({x0, x1, x2});
        float maxx = std::max({x0, x1, x2});
        float miny = std::min({y0, y1, y2});
        float maxy = std::max({y0, y1, y2});
        int x_lo = std::max(0, (int)std::floor(minx));
        int x_hi = std::min(width - 1, (int)std::ceil(maxx));
        int y_lo = std::max(0, (int)std::floor(miny));
        int y_hi = std::min(height - 1, (int)std::ceil(maxy));
        if (x_lo > x_hi || y_lo > y_hi) continue;

        float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
        if (std::fabs(area) < 1e-12f) continue;
        float inv_area = 1.0f / area;
        float iz0 = 1.0f / z0, iz1 = 1.0f / z1, iz2 = 1.0f / z2;
        // texcoords pre-divided by z for perspective-correct interpolation
        float u0 = face_uvs[6 * t + 0] * iz0, v0 = face_uvs[6 * t + 1] * iz0;
        float u1 = face_uvs[6 * t + 2] * iz1, v1 = face_uvs[6 * t + 3] * iz1;
        float u2 = face_uvs[6 * t + 4] * iz2, v2 = face_uvs[6 * t + 5] * iz2;
        int32_t fid = face_ids ? face_ids[t] : t;

        for (int yy = y_lo; yy <= y_hi; ++yy) {
            float pyc = yy + 0.5f;
            for (int xx = x_lo; xx <= x_hi; ++xx) {
                float pxc = xx + 0.5f;
                float w0 = ((x1 - pxc) * (y2 - pyc) - (x2 - pxc) * (y1 - pyc)) * inv_area;
                float w1 = ((x2 - pxc) * (y0 - pyc) - (x0 - pxc) * (y2 - pyc)) * inv_area;
                float w2 = 1.0f - w0 - w1;
                if (w0 < 0.f || w1 < 0.f || w2 < 0.f) continue;
                float iz = w0 * iz0 + w1 * iz1 + w2 * iz2;
                float z = 1.0f / iz;
                size_t idx = (size_t)yy * width + xx;
                if (z < zbuf[idx]) {
                    zbuf[idx] = z;
                    depth_out[idx] = z;
                    face_out[idx] = t;
                    id_out[idx] = fid;
                    uv_out[2 * idx] = (w0 * u0 + w1 * u1 + w2 * u2) * z;
                    uv_out[2 * idx + 1] = (w0 * v0 + w1 * v1 + w2 * v2) * z;
                }
            }
        }
    }
    delete[] zbuf;
    delete[] px;
    delete[] py;
    delete[] pz;
}

}  // extern "C"
