"""Disney/PBR ubershader — the material stage of the wavefront integrator.

The reference dispatches per-triangle function pointers (Shader.proc,
scene.h:30-35); here there is exactly ONE branchless ubershader evaluated
for every shaded ray, selecting behavior from the material table. Both lobes
of the mixture sampler are computed and the sampled one selected — no
divergence. All vectors are component planes (Vec3 of (R,) arrays).

Semantics follow the reference exactly:
- mixture sampler with weights (1 - metalness, luminance(fresnel)),
  sample_disney_BRDF, driver.c:287-348
- GGX VNDF visible-normal sampling with anisotropic alpha_x =
  lerp(r^2, 1, aniso^2), driver.c:230-250, 288-290
- Disney diffuse (double Schlick with FD90) + luminance-normalized sheen,
  driver.c:166-183, 258-264
- Smith G2 specular with shadowed_f90 Schlick fresnel, driver.c:204-276
- returns rgb*NoL and the lobe-weighted pdf; the caller divides
  (tint = rgb/pdf) and terminates on pdf <= 0, driver.c:400-408
- normal mapping via TBN with strength lerp and green-channel flip,
  normal_map_apply, driver.c:129-153
- albedo/emissive textures are sRGB-decoded and multiplied into factors;
  roughness *= mr.g, metalness *= mr.b; roughness clamped to [0.001, 1];
  the metalness remap min(m, 0.9)/0.9, disney_shader_proc driver.c:350-409
- debug shader renders the (mapped) shading normal, driver.c:411-418
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracing_jax.models.scene import SHADER_DEBUG_NORMAL
from raytracing_jax.ops import onehot, texture
from raytracing_jax.utils import color
from raytracing_jax.utils.vec3 import Vec3

PI = jnp.float32(jnp.pi)


def luminance(v: Vec3):
    return v.x * color.LUMA[0] + v.y * color.LUMA[1] + v.z * color.LUMA[2]


def srgb_to_linear_v(v: Vec3) -> Vec3:
    return v.map(color.srgb_to_linear)


# ---------------------------------------------------------------------------
# BRDF pieces (tangent space, normal = +z)
# ---------------------------------------------------------------------------


def fresnel_schlick_scalar(f0, f90, theta):
    """driver.c:204-206."""
    return f0 + (f90 - f0) * jnp.power(jnp.maximum(1.0 - theta, 0.0), 5.0)


def fresnel_schlick_rgb(f0: Vec3, f90, theta) -> Vec3:
    """driver.c:208-210."""
    p = jnp.power(jnp.maximum(1.0 - theta, 0.0), 5.0)
    return f0 + (Vec3(f90, f90, f90) - f0) * p


def distribution_ggx(roughness, noh, k):
    """driver.c:212-215."""
    a2 = roughness * roughness
    return a2 / (PI * jnp.power((noh * noh) * (a2 * a2 - 1.0) + 1.0, k))


def smith_g(ndotv, alpha2):
    """driver.c:217-221."""
    a = alpha2 * alpha2
    b = ndotv * ndotv
    return (2.0 * ndotv) / (ndotv + jnp.sqrt(jnp.maximum(a + b - a * b, 0.0)))


def geometry_term(nol, nov, roughness):
    """driver.c:223-228."""
    a2 = roughness * roughness
    return smith_g(nov, a2) * smith_g(nol, a2)


def shadowed_f90(f0: Vec3):
    """driver.c:273-276."""
    return jnp.minimum(1.0, (1.0 / 0.04) * luminance(f0))


def sheen_tint_color(base_color: Vec3) -> Vec3:
    """disney_calculate_sheen_tint (driver.c:166-169)."""
    lum = base_color.x * 0.3 + base_color.y * 0.6 + base_color.z * 1.0
    tint = base_color * (1.0 / jnp.maximum(lum, 1e-20))
    one = jnp.ones_like(lum)
    return Vec3.where(lum > 0.0, tint, Vec3(one, one, one))


def evaluate_sheen(sheen, base_color: Vec3, sheen_tint, hol) -> Vec3:
    """disney_evaluate_sheen (driver.c:176-183)."""
    tint = sheen_tint_color(base_color)
    one = jnp.ones_like(sheen)
    white = Vec3(one, one, one)
    col = white.lerp(tint, sheen_tint)
    m = jnp.maximum(1.0 - hol, 0.0)
    weight = sheen * (m * m * m * m * m)
    out = col * weight
    return Vec3.where(sheen > 0.0, out, Vec3.zeros(jnp.shape(sheen)))


def eval_diffuse(base_color: Vec3, nol, nov, loh, roughness) -> Vec3:
    """disney_eval_diffuse (driver.c:258-264)."""
    fd90 = 0.5 + 2.0 * roughness * loh * loh
    a = fresnel_schlick_scalar(1.0, fd90, nol)
    b = fresnel_schlick_scalar(1.0, fd90, nov)
    return base_color * (a * b / PI)


def eval_specular(roughness, fresnel: Vec3, noh, nov, nol) -> Vec3:
    """disney_eval_specular (driver.c:266-271)."""
    d = distribution_ggx(roughness, noh, 2.0)
    g = geometry_term(nol, nov, roughness)
    return fresnel * (d * g / (4.0 * nol * nov))


def pdf_ggx_vndf(noh, nov, roughness):
    """pdf_GGX_VNDF (driver.c:252-256)."""
    d = distribution_ggx(roughness, noh, 2.0)
    g1 = smith_g(nov, roughness * roughness)
    return (d * g1) / jnp.maximum(1e-5, 4.0 * nov)


def sample_cosine_hemisphere(u1, u2) -> Vec3:
    """driver.c:118-127: z-up cosine-weighted direction."""
    angle = u1 * 2.0 * PI
    dist = jnp.sqrt(u2)
    return Vec3(
        x=jnp.sin(angle) * dist,
        y=jnp.cos(angle) * dist,
        z=jnp.sqrt(jnp.maximum(1.0 - dist * dist, 0.0)),
    )


def sample_ggx_vndf(v: Vec3, ax, ay, u1, u2) -> Vec3:
    """sample_GGX_VNDF (driver.c:230-250): visible-normal sampling."""
    vh = Vec3(ax * v.x, ay * v.y, v.z).normalized()

    lensq = vh.x * vh.x + vh.y * vh.y
    inv_len = jnp.where(
        lensq > 0.0, 1.0 / jnp.sqrt(jnp.maximum(lensq, 1e-30)), 0.0
    )
    has = lensq > 0.0
    one = jnp.ones_like(inv_len)
    zero = jnp.zeros_like(inv_len)
    t1 = Vec3.where(
        has,
        Vec3(-vh.y * inv_len, vh.x * inv_len, zero),
        Vec3(one, zero, zero),
    )
    t2 = vh.cross(t1)

    r = jnp.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh.z)
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - p1 * p1, 0.0)) + s * p2

    nh = t1 * p1 + t2 * p2 + vh * jnp.sqrt(
        jnp.maximum(0.0, 1.0 - p1 * p1 - p2 * p2)
    )
    return Vec3(ax * nh.x, ay * nh.y, jnp.maximum(0.0, nh.z)).normalized()


def sample_disney_brdf(
    base_color: Vec3, roughness, metalness, sheen, sheen_tint, aniso2,
    in_dir: Vec3, u_lobe, u1, u2,
):
    """sample_disney_BRDF (driver.c:287-348) in tangent space (normal = +z).

    in_dir points AWAY from the surface toward the viewer. Returns
    (out_dir, rgb: Vec3, pdf) where rgb includes NoL and pdf includes the
    lobe selection weight; pdf <= 0 means terminate.
    """
    alpha_x = roughness * roughness * (1.0 - aniso2) + aniso2
    alpha_y = roughness * roughness
    micro_n = sample_ggx_vndf(in_dir, alpha_x, alpha_y, u1, u2)

    f004 = Vec3.full(jnp.shape(roughness), 0.04)
    f0 = f004.lerp(base_color, metalness)
    fresnel = fresnel_schlick_rgb(f0, shadowed_f90(f0), in_dir.dot(micro_n))

    dw = 1.0 - metalness
    sw = luminance(fresnel)
    inv_w = 1.0 / jnp.maximum(dw + sw, 1e-20)
    dw = dw * inv_w
    sw = sw * inv_w

    pick_diffuse = u_lobe < dw
    nov = in_dir.z

    # --- diffuse lobe (cosine hemisphere) -------------------------------
    out_d = sample_cosine_hemisphere(u1, u2)
    half_d = (out_d + in_dir).normalized()
    nol_d = out_d.z
    ok_d = (nol_d > 0.0) & (nov > 0.0)
    loh = out_d.dot(half_d)
    pdf_d = nol_d / PI
    one = jnp.ones_like(nov)
    white = Vec3(one, one, one)
    diff = eval_diffuse(base_color, nol_d, nov, loh, roughness) * (
        white - fresnel
    ) + evaluate_sheen(sheen, base_color, sheen_tint, loh)
    rgb_d = diff * jnp.where(ok_d, nol_d, 0.0)
    a_d = jnp.where(ok_d, dw * pdf_d, 0.0)

    # --- specular lobe (VNDF reflection) --------------------------------
    out_s = (-in_dir).reflect(micro_n)
    nol_s = out_s.z
    ok_s = (nol_s > 0.0) & (nov > 0.0)
    nol_sc = jnp.maximum(nol_s, 0.001)
    nov_sc = jnp.maximum(nov, 0.001)
    noh = jnp.minimum(micro_n.z, 0.99)
    pdf_s = pdf_ggx_vndf(noh, nov_sc, roughness)
    spec = eval_specular(roughness, fresnel, noh, nov_sc, nol_sc)
    rgb_s = spec * jnp.where(ok_s, nol_sc, 0.0)
    a_s = jnp.where(ok_s, sw * pdf_s, 0.0)

    # --- select ----------------------------------------------------------
    out_dir = Vec3.where(pick_diffuse, out_d, out_s).normalized()
    rgb = Vec3.where(pick_diffuse, rgb_d, rgb_s)
    pdf = jnp.where(pick_diffuse, a_d, a_s)
    return out_dir, rgb, pdf


def eval_disney_brdf(
    base_color: Vec3, roughness, metalness, sheen, sheen_tint,
    in_dir: Vec3, out_dir: Vec3,
):
    """Deterministic BRDF evaluation for a GIVEN direction (BEYOND-PARITY:
    the reference only samples, driver.c:287-348 — NEE/MIS needs eval).

    Tangent space (normal = +z); in_dir points toward the viewer, out_dir
    toward the light. Returns (f_nol: Vec3, pdf) where f_nol = full
    two-lobe BRDF x NoL and pdf is the lobe-mixture sampling density of
    out_dir with the Fresnel lobe weight taken at the true half vector —
    deterministic, so MIS weights built from it sum to one across
    strategies. Mirrors the sampler's formulas (isotropic pdf, same
    clamps); both lobes contribute to f (physically both reflect)."""
    nov = jnp.maximum(in_dir.z, 0.001)
    nol = out_dir.z
    ok = (nol > 0.0) & (in_dir.z > 0.0)
    nol_c = jnp.maximum(nol, 0.001)

    h = (in_dir + out_dir).normalized()
    noh = jnp.minimum(h.z, 0.99)
    loh = out_dir.dot(h)

    f004 = Vec3.full(jnp.shape(roughness), 0.04)
    f0 = f004.lerp(base_color, metalness)
    fresnel = fresnel_schlick_rgb(f0, shadowed_f90(f0), in_dir.dot(h))

    dw = 1.0 - metalness
    sw = luminance(fresnel)
    inv_w = 1.0 / jnp.maximum(dw + sw, 1e-20)
    dw = dw * inv_w
    sw = sw * inv_w

    one = jnp.ones_like(nov)
    white = Vec3(one, one, one)
    diff = eval_diffuse(base_color, nol_c, nov, loh, roughness) * (
        white - fresnel
    ) + evaluate_sheen(sheen, base_color, sheen_tint, loh)
    spec = eval_specular(roughness, fresnel, noh, nov, nol_c)

    f_nol = (diff + spec) * jnp.where(ok, nol_c, 0.0)
    pdf = dw * jnp.maximum(nol, 0.0) / PI + sw * pdf_ggx_vndf(
        noh, nov, roughness
    )
    return f_nol, jnp.where(ok, pdf, 0.0)


def sample_uniform_sphere(u1, u2) -> Vec3:
    """Uniform direction on the sphere (pdf = 1/4pi) — the environment
    light's NEE sampling distribution. Direction-only pdf keeps the
    BRDF-side MIS weight computable at the miss point without carrying the
    sampling frame."""
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u2
    return Vec3(r * jnp.cos(phi), r * jnp.sin(phi), z)


#: pdf of sample_uniform_sphere
UNIFORM_SPHERE_PDF = float(1.0 / (4.0 * jnp.pi))


# ---------------------------------------------------------------------------
# Ubershader (world space, full material stage)
# ---------------------------------------------------------------------------


def apply_normal_map(normal: Vec3, tangent: Vec3, bitangent: Vec3,
                     tex_rgb: Vec3, strength, has_map) -> Vec3:
    """normal_map_apply (driver.c:129-153): TBN transform with green flip
    and strength lerp toward the interpolated normal."""
    vx = tex_rgb.x * 2.0 - 1.0
    vy = -(tex_rgb.y * 2.0 - 1.0)  # v.g *= -1
    vz = tex_rgb.z * 2.0 - 1.0
    mapped = tangent * vx + bitangent * vy + normal * vz
    n = (mapped * strength + normal * (1.0 - strength)).normalized()
    return Vec3.where(has_map, n, normal)


def basis(view: Vec3, normal: Vec3):
    """View-aligned tangent basis (driver.c:155-164): tangent =
    normalize(cross(normal, view)) unless normal ~ view, falling back to the
    +Y then +X axes. Returns (tangent, bitangent)."""
    zero = jnp.zeros_like(normal.x)
    one = jnp.ones_like(normal.x)
    up_y = Vec3(zero, one, zero)
    up_x = Vec3(one, zero, zero)

    use_view = jnp.abs(normal.dot(view)) < 0.9999
    use_y = jnp.abs(normal.y) < 0.9999

    t = Vec3.where(
        use_view,
        normal.cross(view),
        Vec3.where(use_y, normal.cross(up_y), normal.cross(up_x)),
    ).normalized()
    b = normal.cross(t)
    return t, b


def shade(scene, direction: Vec3, normal: Vec3, normal_geo: Vec3,
          tangent: Vec3, bitangent: Vec3, uv_u, uv_v, mat_id, rand4,
          texture_mode: str = "bilinear", nee: bool = False, rand2=None):
    """The full material stage for a batch of shaded rays.

    direction: incoming ray direction (toward the surface); normal: unit
    interpolated shading normal; rand4: (4, R) uniforms (lobe, u1, u2,
    spare). Returns dict(direction, tint, emission, terminate, normal)
    mirroring Shader_Output (scene.h:24-28).

    nee (BEYOND-PARITY, default off): also draw one environment-light
    sample per vertex (uniform sphere, rand2: (2, R)) and return
    `nee_dir` (world) + `nee_partial` (env radiance x BRDF x NoL x
    MIS weight / pdf — everything except visibility, which the caller
    resolves with a shadow ray) and `pdf_eval` (the deterministic
    mixture pdf of the SAMPLED scatter direction, for the BRDF-side MIS
    weight at the next miss). Power-heuristic MIS against the uniform
    env pdf; weights from eval_disney_brdf so the two strategies' weights
    sum to one per direction.
    """
    from raytracing_jax.models.scene import (
        MROW_ANISO, MROW_BASE, MROW_EMI, MROW_KIND, MROW_METAL, MROW_NSTR,
        MROW_ROUGH, MROW_SHEEN, MROW_SHEENT, MROW_TEX_ALBEDO, MROW_TEX_EMI,
        MROW_TEX_MR, MROW_TEX_NORMAL,
    )

    mid = jnp.maximum(mat_id, 0)
    rows = scene.materials.rows
    if rows.shape[0] <= 256:
        # exact one-hot matmul fetch, batch-minor directly — no per-lane
        # row gather and no (R, 128) -> (128, R) relayout; < 0.2 M MAC/ray at
        # n_mats <= 256 (ops/onehot.py holds the precision invariant)
        m = onehot.fetch_rows_exact(jnp.transpose(rows), mid)
    else:
        # huge material tables: per-ray 512-byte row gather
        m = jnp.transpose(rows[mid])  # (128, R)

    base_color = Vec3(m[MROW_BASE], m[MROW_BASE + 1], m[MROW_BASE + 2])
    emission = Vec3(m[MROW_EMI], m[MROW_EMI + 1], m[MROW_EMI + 2])
    rough = m[MROW_ROUGH]
    metal = m[MROW_METAL]
    nstr = m[MROW_NSTR]
    sheen = m[MROW_SHEEN]
    sheen_tint = m[MROW_SHEENT]
    aniso = m[MROW_ANISO]
    t_alb = m[MROW_TEX_ALBEDO].astype(jnp.int32)
    t_nrm = m[MROW_TEX_NORMAL].astype(jnp.int32)
    t_mr = m[MROW_TEX_MR].astype(jnp.int32)
    t_emi = m[MROW_TEX_EMI].astype(jnp.int32)
    kind = m[MROW_KIND].astype(jnp.int32)

    # normal mapping
    nrm_tex = texture.sample(scene.atlas, t_nrm, uv_u, uv_v, texture_mode)
    n = apply_normal_map(normal, tangent, bitangent, nrm_tex, nstr, t_nrm >= 0)

    # albedo / metal-roughness / emissive textures (driver.c:354-379)
    alb_tex = texture.sample(scene.atlas, t_alb, uv_u, uv_v, texture_mode)
    base_color = Vec3.where(
        t_alb >= 0, base_color * srgb_to_linear_v(alb_tex), base_color
    )
    mr_tex = texture.sample(scene.atlas, t_mr, uv_u, uv_v, texture_mode)
    has_mr = t_mr >= 0
    rough = jnp.where(has_mr, rough * mr_tex.y, rough)
    metal = jnp.where(has_mr, metal * mr_tex.z, metal)

    rough = jnp.clip(rough, 0.001, 1.0)
    # metalness remap (driver.c:370-373)
    metal = jnp.minimum(metal, 0.9) / 0.9

    emi_tex = texture.sample(scene.atlas, t_emi, uv_u, uv_v, texture_mode)
    emission = Vec3.where(
        t_emi >= 0, emission * srgb_to_linear_v(emi_tex), emission
    )

    # view-aligned tangent basis + world<->tangent (driver.c:381-395)
    t_basis, b_basis = basis(direction, n)
    neg_dir = -direction
    in_dir = Vec3(neg_dir.dot(t_basis), neg_dir.dot(b_basis), neg_dir.dot(n))

    out_t, rgb, pdf = sample_disney_brdf(
        base_color, rough, metal, sheen, sheen_tint, aniso * aniso,
        in_dir, rand4[0], rand4[1], rand4[2],
    )
    out_world = t_basis * out_t.x + b_basis * out_t.y + n * out_t.z

    ok = pdf > 0.0
    inv_pdf = jnp.where(ok, 1.0 / jnp.where(ok, pdf, 1.0), 0.0)
    tint = rgb * inv_pdf
    terminate = ~ok

    # debug shader: emit the shading normal and stop (driver.c:411-418)
    is_debug = kind == SHADER_DEBUG_NORMAL
    emission = Vec3.where(is_debug, n * 0.5 + 0.5, emission)
    terminate = jnp.where(is_debug, True, terminate)

    out = {
        "direction": out_world,
        "tint": tint,
        "emission": emission,
        "terminate": terminate,
        "normal": n,
    }

    if nee:
        from raytracing_jax.ops import background as bg_ops

        env = getattr(scene, "env_light", None)
        if env is not None:
            # luminance-CDF importance sample (alias table) + exact pdf
            from raytracing_jax.ops import env_light as el

            wd, pl = el.sample(env, rand2[0], rand2[1], rand2[2])
        else:
            wd = sample_uniform_sphere(rand2[0], rand2[1])  # world
            pl = UNIFORM_SPHERE_PDF
        wd_t = Vec3(wd.dot(t_basis), wd.dot(b_basis), wd.dot(n))
        f_nol, pdf_ev = eval_disney_brdf(
            base_color, rough, metal, sheen, sheen_tint, in_dir, wd_t
        )
        big_l = bg_ops.eval_background(scene, wd)
        w_nee = (pl * pl) / (pl * pl + pdf_ev * pdf_ev)
        ok_l = pl > 0.0
        inv_pl = jnp.where(ok_l, 1.0 / jnp.where(ok_l, pl, 1.0), 0.0)
        partial = big_l * f_nol * jnp.where(is_debug, 0.0, w_nee * inv_pl)
        # deterministic mixture pdf of the CHOSEN scatter direction
        _, pdf_out = eval_disney_brdf(
            base_color, rough, metal, sheen, sheen_tint, in_dir, out_t
        )
        out["nee_dir"] = wd
        out["nee_partial"] = partial
        out["pdf_eval"] = jnp.where(is_debug, jnp.inf, pdf_out)

    return out
