"""HEVC parameter sets (VPS/SPS/PPS) and slice headers: compose + parse.

Mirrors the configuration surface the reference exposes through kvazaar
(uvgComm src/media/processing/kvazaarfilter.cpp:176-276 maps ~25
settings into kvz_config) — here the static coded-stream side of it.

Only syntax needed by the engine's current toolset is emitted; every field is
written exactly per ITU-T H.265. Parsers accept the subset we emit plus a
tolerant superset (enough to parse x265-generated streams for decoder tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bitstream import BitReader, BitWriter
from .nal import NalType, NalUnit


@dataclass
class StreamConfig:
    """Static per-stream coding configuration (the SPS/PPS surface)."""

    width: int = 352
    height: int = 288
    qp: int = 32
    ctb_log2: int = 4  # 16x16 CTBs (v1); 32/64 supported by the tables
    min_cb_log2: int = 4
    min_tb_log2: int = 2
    max_tb_log2: int = 4
    max_transform_hierarchy_depth_intra: int = 0
    max_transform_hierarchy_depth_inter: int = 0
    bit_depth: int = 8
    sao_enabled: bool = False
    deblocking_enabled: bool = True  # production default; tests that need
    # the no-filter path set it explicitly
    strong_intra_smoothing: bool = False
    sign_data_hiding: bool = False
    amp_enabled: bool = False
    wpp: bool = False  # entropy_coding_sync (WPP substreams)
    tile_cols: int = 1  # >1 -> tiles_enabled (uniform tile columns, 1 row)
    slices: int = 1  # >1 -> row-aligned independent slices per picture
    dependent_slices: bool = False  # emit slices as dependent slice segments
    pcm_enabled: bool = False  # PCM (raw-sample) CUs, 8-bit, 16x16 only
    pcm_min_log2: int = 4
    pcm_max_log2: int = 4
    lists_modification: bool = False  # RPLM present in slice headers
    long_term_refs: bool = False  # long_term_ref_pics_present
    cu_qp_delta: bool = False  # per-CTB adaptive QP (ROI / spatial RC)
    rdoq: bool = False  # RD-optimized quantization (RDOQ-lite; needs lambda
    # calibration before it beats the tuned deadzone — kept opt-in)
    fast_decision: bool = True  # dense orig-boundary mode decision prepass
    # + ring-carry recon scan (encoder-only speed/quality trade; streams
    # stay conformant).  False = in-scan RD decisions on recon boundaries.
    merge_cand: int = 1  # MaxNumMergeCand for P slices (kvazaar --merge);
    # >1 needs the fast-decision P path (evaluates the full spec list)
    level_idc: int = 123  # level 4.1
    max_dec_pic_buffering: int = 2
    num_reorder_pics: int = 0
    log2_max_poc_lsb: int = 8
    # inter coding (used from the P/B milestones onward)
    temporal_mvp: bool = False
    num_ref_l0: int = 1
    num_ref_l1: int = 1
    # conformance window (7.4.3.2.1): display_width/height are the true
    # source dimensions; width/height stay the CTB-aligned CODED size.
    # 0 = no cropping.  The encoder pads at ingress (edge replication)
    # and the SPS signals right/bottom crop offsets, so e.g. a true
    # 1920x1080 stream codes 1920x1088 and decodes to 1080 rows.
    display_width: int = 0
    display_height: int = 0

    @property
    def out_width(self) -> int:
        return self.display_width or self.width

    @property
    def out_height(self) -> int:
        return self.display_height or self.height

    @classmethod
    def for_source(cls, width: int, height: int, **kw) -> "StreamConfig":
        """Config for a true source size: rounds the coded size up to the
        CTB grid and signals the difference as the conformance window
        (any kvazaar 1080p encode does the same — VERDICT r3 #8)."""
        ctb = 1 << kw.get("ctb_log2", 4)
        cw = -(-width // ctb) * ctb
        ch = -(-height // ctb) * ctb
        dw = width if cw != width else 0
        dh = height if ch != height else 0
        return cls(width=cw, height=ch, display_width=dw,
                   display_height=dh, **kw)

    @property
    def ctb_size(self) -> int:
        return 1 << self.ctb_log2

    @property
    def ctbs_w(self) -> int:
        return -(-self.width // self.ctb_size)

    @property
    def ctbs_h(self) -> int:
        return -(-self.height // self.ctb_size)


def _profile_tier_level(w: BitWriter, cfg: StreamConfig) -> None:
    main10 = cfg.bit_depth > 8
    w.u(0, 2)  # general_profile_space
    w.flag(0)  # general_tier_flag
    w.u(2 if main10 else 1, 5)  # general_profile_idc: Main10 / Main
    compat = [0] * 32
    if not main10:
        compat[1] = 1  # Main
    compat[2] = 1  # Main streams also conform to Main10
    for b in compat:
        w.flag(b)
    w.flag(1)  # general_progressive_source_flag
    w.flag(0)  # general_interlaced_source_flag
    w.flag(0)  # general_non_packed_constraint_flag
    w.flag(1)  # general_frame_only_constraint_flag
    w.u(0, 32)  # general_reserved_zero_43bits...
    w.u(0, 11)
    w.flag(0)  # general_reserved/inbld
    w.u(cfg.level_idc, 8)


def _parse_profile_tier_level(r: BitReader, max_sub_layers_minus1: int = 0) -> dict:
    out = {}
    out["profile_space"] = r.u(2)
    out["tier"] = r.flag()
    out["profile_idc"] = r.u(5)
    out["compat"] = [r.flag() for _ in range(32)]
    out["progressive"] = r.flag()
    out["interlaced"] = r.flag()
    out["non_packed"] = r.flag()
    out["frame_only"] = r.flag()
    r.u(32)
    r.u(11)
    r.flag()
    out["level_idc"] = r.u(8)
    sub_profile_present = []
    sub_level_present = []
    for _ in range(max_sub_layers_minus1):
        sub_profile_present.append(r.flag())
        sub_level_present.append(r.flag())
    if max_sub_layers_minus1 > 0:
        for _ in range(8 - max_sub_layers_minus1):
            r.u(2)
    for i in range(max_sub_layers_minus1):
        if sub_profile_present[i]:
            r.u(32)
            r.u(32)
            r.u(24)  # 88 bits
        if sub_level_present[i]:
            r.u(8)
    return out


def compose_vps(cfg: StreamConfig) -> NalUnit:
    w = BitWriter()
    w.u(0, 4)  # vps_video_parameter_set_id
    w.flag(1)  # vps_base_layer_internal_flag
    w.flag(1)  # vps_base_layer_available_flag
    w.u(0, 6)  # vps_max_layers_minus1
    w.u(0, 3)  # vps_max_sub_layers_minus1
    w.flag(1)  # vps_temporal_id_nesting_flag
    w.u(0xFFFF, 16)  # vps_reserved_0xffff_16bits
    _profile_tier_level(w, cfg)
    w.flag(1)  # vps_sub_layer_ordering_info_present_flag
    w.ue(cfg.max_dec_pic_buffering - 1)
    w.ue(cfg.num_reorder_pics)
    w.ue(0)  # vps_max_latency_increase_plus1
    w.u(0, 6)  # vps_max_layer_id
    w.ue(0)  # vps_num_layer_sets_minus1
    w.flag(0)  # vps_timing_info_present_flag
    w.flag(0)  # vps_extension_flag
    w.rbsp_trailing_bits()
    return NalUnit(NalType.VPS, w.data())


def compose_sps(cfg: StreamConfig) -> NalUnit:
    if cfg.width % (1 << cfg.min_cb_log2) or cfg.height % (1 << cfg.min_cb_log2):
        raise ValueError("picture size must be a multiple of the min CB size (pad first)")
    w = BitWriter()
    w.u(0, 4)  # sps_video_parameter_set_id
    w.u(0, 3)  # sps_max_sub_layers_minus1
    w.flag(1)  # sps_temporal_id_nesting_flag
    _profile_tier_level(w, cfg)
    w.ue(0)  # sps_seq_parameter_set_id
    w.ue(1)  # chroma_format_idc = 4:2:0
    w.ue(cfg.width)
    w.ue(cfg.height)
    crop_r = cfg.width - cfg.out_width
    crop_b = cfg.height - cfg.out_height
    if crop_r or crop_b:
        if crop_r % 2 or crop_b % 2 or crop_r < 0 or crop_b < 0:
            raise ValueError("conformance crop must be a non-negative "
                             "multiple of 2 (4:2:0 SubWidthC/SubHeightC)")
        w.flag(1)  # conformance_window_flag
        w.ue(0)  # left offset
        w.ue(crop_r // 2)  # right offset (in SubWidthC units)
        w.ue(0)  # top offset
        w.ue(crop_b // 2)  # bottom offset
    else:
        w.flag(0)  # conformance_window_flag
    w.ue(cfg.bit_depth - 8)
    w.ue(cfg.bit_depth - 8)
    w.ue(cfg.log2_max_poc_lsb - 4)
    w.flag(1)  # sps_sub_layer_ordering_info_present_flag
    w.ue(cfg.max_dec_pic_buffering - 1)
    w.ue(cfg.num_reorder_pics)
    w.ue(0)
    w.ue(cfg.min_cb_log2 - 3)
    w.ue(cfg.ctb_log2 - cfg.min_cb_log2)
    w.ue(cfg.min_tb_log2 - 2)
    w.ue(cfg.max_tb_log2 - cfg.min_tb_log2)
    w.ue(cfg.max_transform_hierarchy_depth_inter)
    w.ue(cfg.max_transform_hierarchy_depth_intra)
    w.flag(0)  # scaling_list_enabled_flag
    w.flag(cfg.amp_enabled)
    w.flag(cfg.sao_enabled)
    w.flag(cfg.pcm_enabled)  # pcm_enabled_flag
    if cfg.pcm_enabled:
        w.u(7, 4)  # pcm_sample_bit_depth_luma_minus1 (8-bit)
        w.u(7, 4)  # pcm_sample_bit_depth_chroma_minus1
        w.ue(cfg.pcm_min_log2 - 3)
        w.ue(cfg.pcm_max_log2 - cfg.pcm_min_log2)
        w.flag(0)  # pcm_loop_filter_disabled_flag
    w.ue(0)  # num_short_term_ref_pic_sets
    w.flag(cfg.long_term_refs)  # long_term_ref_pics_present_flag
    if cfg.long_term_refs:
        w.ue(0)  # num_long_term_ref_pics_sps
    w.flag(cfg.temporal_mvp)
    w.flag(cfg.strong_intra_smoothing)
    w.flag(0)  # vui_parameters_present_flag
    w.flag(0)  # sps_extension_present_flag
    w.rbsp_trailing_bits()
    return NalUnit(NalType.SPS, w.data())


def compose_pps(cfg: StreamConfig) -> NalUnit:
    w = BitWriter()
    w.ue(0)  # pps_pic_parameter_set_id
    w.ue(0)  # pps_seq_parameter_set_id
    w.flag(cfg.dependent_slices)  # dependent_slice_segments_enabled_flag
    w.flag(0)  # output_flag_present_flag
    w.u(0, 3)  # num_extra_slice_header_bits
    w.flag(cfg.sign_data_hiding)
    w.flag(0)  # cabac_init_present_flag
    w.ue(cfg.num_ref_l0 - 1)
    w.ue(cfg.num_ref_l1 - 1)
    w.se(cfg.qp - 26)  # init_qp_minus26
    w.flag(0)  # constrained_intra_pred_flag
    w.flag(0)  # transform_skip_enabled_flag
    w.flag(cfg.cu_qp_delta)  # cu_qp_delta_enabled_flag
    if cfg.cu_qp_delta:
        w.ue(0)  # diff_cu_qp_delta_depth: quant group == CTB
    w.se(0)  # pps_cb_qp_offset
    w.se(0)  # pps_cr_qp_offset
    w.flag(0)  # pps_slice_chroma_qp_offsets_present_flag
    w.flag(0)  # weighted_pred_flag
    w.flag(0)  # weighted_bipred_flag
    w.flag(0)  # transquant_bypass_enabled_flag
    tiles = cfg.tile_cols > 1
    w.flag(tiles)  # tiles_enabled_flag
    w.flag(cfg.wpp)  # entropy_coding_sync_enabled_flag
    if tiles:
        w.ue(cfg.tile_cols - 1)  # num_tile_columns_minus1
        w.ue(0)  # num_tile_rows_minus1
        w.flag(1)  # uniform_spacing_flag
        w.flag(1)  # loop_filter_across_tiles_enabled_flag
    w.flag(1)  # pps_loop_filter_across_slices_enabled_flag
    w.flag(1)  # deblocking_filter_control_present_flag
    w.flag(0)  # deblocking_filter_override_enabled_flag
    w.flag(not cfg.deblocking_enabled)  # pps_deblocking_filter_disabled_flag
    if cfg.deblocking_enabled:
        w.se(0)  # pps_beta_offset_div2
        w.se(0)  # pps_tc_offset_div2
    w.flag(0)  # pps_scaling_list_data_present_flag
    w.flag(cfg.lists_modification)  # lists_modification_present_flag
    w.ue(0)  # log2_parallel_merge_level_minus2
    w.flag(0)  # slice_segment_header_extension_present_flag
    w.flag(0)  # pps_extension_present_flag
    w.rbsp_trailing_bits()
    return NalUnit(NalType.PPS, w.data())


@dataclass
class SliceHeader:
    slice_type: int = 2  # 0=B 1=P 2=I
    qp: int = 32
    first_slice: bool = True
    nal_type: int = NalType.IDR_W_RADL
    pic_order_cnt_lsb: int = 0
    segment_address: int = 0
    # short-term RPS (inline): negative deltas (past refs) + positive (future)
    num_negative_pics: int = 0
    delta_pocs: tuple = ()
    pos_deltas: tuple = ()
    # used_by_curr_pic flags per RPS entry (empty tuple = all 1).  Entries
    # with used = 0 are retained in the DPB but excluded from the reference
    # lists — how the B-pyramid keeps higher anchors alive (7.4.8 RPS
    # semantics) while L0[0]/L1[0] stay the two active references.
    neg_used: tuple = ()
    pos_used: tuple = ()
    # per-slice slice_temporal_mvp_enabled_flag override (None = follow
    # cfg.temporal_mvp): B slices in the RA pyramid code with TMVP off
    # while the P anchors keep it
    tmvp: bool | None = None
    num_ref_idx_l0: int = 1
    max_num_merge_cand: int = 1  # MaxNumMergeCand for this slice
    sao_luma: bool = False
    sao_chroma: bool = False
    deblocking_disabled: bool = True
    dependent: bool = False  # dependent slice segment (7.3.6.1)
    lt_pics: tuple = ()  # write side: (poc_lsb, used, msb_present, cycle)
    list_entry_l0: tuple | None = None  # RPLM entries (7.3.6.2)


def compose_slice_header(cfg: StreamConfig, sh: SliceHeader, entry_offsets=None) -> BitWriter:
    """Compose a slice segment header; returns the (unaligned-aware) writer so
    the caller can append CABAC payload after byte_alignment().

    entry_offsets: per-substream byte lengths for WPP/tiles (all but last)."""
    w = BitWriter()
    w.flag(sh.first_slice)
    from .nal import is_irap

    if is_irap(sh.nal_type):
        w.flag(0)  # no_output_of_prior_pics_flag
    w.ue(0)  # slice_pic_parameter_set_id
    if not sh.first_slice:
        if cfg.dependent_slices:
            w.flag(sh.dependent)
        addr_bits = _ceil_log2(cfg.ctbs_w * cfg.ctbs_h)
        w.u(sh.segment_address, addr_bits)
    if sh.dependent:
        # dependent segments carry only the address (+ entry points); all
        # other fields are inherited from the preceding independent segment
        if cfg.wpp or cfg.tile_cols > 1:
            offs = entry_offsets or []
            w.ue(len(offs))
            if offs:
                offset_len = max(o - 1 for o in offs).bit_length() or 1
                w.ue(offset_len - 1)
                for o in offs:
                    w.u(o - 1, offset_len)
        w.byte_alignment()
        return w
    w.ue(sh.slice_type)
    from .nal import is_idr

    if not is_idr(sh.nal_type):
        w.u(sh.pic_order_cnt_lsb, cfg.log2_max_poc_lsb)
        w.flag(0)  # short_term_ref_pic_set_sps_flag -> coded inline
        # st_ref_pic_set(num_short_term_ref_pic_sets=0 -> idx 0, no inter-rps)
        w.ue(sh.num_negative_pics)
        w.ue(len(sh.pos_deltas))  # num_positive_pics
        neg_used = sh.neg_used or (1,) * len(sh.delta_pocs)
        pos_used = sh.pos_used or (1,) * len(sh.pos_deltas)
        prev = 0
        for dp, us in zip(sh.delta_pocs, neg_used):
            w.ue(-dp + prev - 1)  # delta_poc_s0_minus1
            prev = dp
            w.flag(1 if us else 0)  # used_by_curr_pic_s0_flag
        prev = 0
        for dp, us in zip(sh.pos_deltas, pos_used):  # positive pics ascending
            w.ue(dp - prev - 1)
            prev = dp
            w.flag(1 if us else 0)  # used_by_curr_pic_s1_flag
        if cfg.long_term_refs:
            w.ue(len(sh.lt_pics))  # num_long_term_pics (no SPS LT set)
            for (lsb, used, msb_present, cycle) in sh.lt_pics:
                w.u(lsb, cfg.log2_max_poc_lsb)
                w.flag(used)
                w.flag(msb_present)
                if msb_present:
                    w.ue(cycle)
        if cfg.temporal_mvp:
            eff_tmvp = cfg.temporal_mvp if sh.tmvp is None else sh.tmvp
            w.flag(1 if eff_tmvp else 0)  # slice_temporal_mvp_enabled_flag
    if cfg.sao_enabled:
        w.flag(sh.sao_luma)
        w.flag(sh.sao_chroma)
    if sh.slice_type != 2:
        w.flag(0)  # num_ref_idx_active_override_flag (use PPS defaults)
        if cfg.lists_modification:
            npt = (len(sh.delta_pocs) + len(sh.pos_deltas)
                   + sum(1 for lt in sh.lt_pics if lt[1]))
            if npt > 1:
                nb = _ceil_log2(npt)
                w.flag(sh.list_entry_l0 is not None)
                if sh.list_entry_l0 is not None:
                    for e in sh.list_entry_l0[: cfg.num_ref_l0]:
                        w.u(e, nb)
                if sh.slice_type == 0:
                    w.flag(0)  # ref_pic_list_modification_flag_l1
        if sh.slice_type == 0:
            w.flag(0)  # mvd_l1_zero_flag
        # cabac_init_present=0 -> no cabac_init_flag
        if cfg.temporal_mvp and sh.slice_type == 0 \
                and (sh.tmvp is None or sh.tmvp):
            # collocated_from_l0_flag: present for B slices only (7.3.6.1)
            # when the slice enables TMVP; P infers 1.  collocated_ref_idx
            # absent with one active ref.
            w.flag(1)
        w.ue(5 - sh.max_num_merge_cand)  # five_minus_max_num_merge_cand
    w.se(sh.qp - cfg.qp)  # slice_qp_delta relative to init_qp
    # deblocking: pps has control_present=1, override_enabled=0 -> nothing here
    # loop_filter_across_slices: condition false when sao+deblock off
    if cfg.sao_enabled or not sh.deblocking_disabled or cfg.deblocking_enabled:
        w.flag(1)  # slice_loop_filter_across_slices_enabled_flag
    if cfg.wpp or cfg.tile_cols > 1:
        offs = entry_offsets or []
        w.ue(len(offs))
        if offs:
            offset_len = max(o - 1 for o in offs).bit_length() or 1
            w.ue(offset_len - 1)
            for o in offs:
                w.u(o - 1, offset_len)
    w.byte_alignment()
    return w


def _ceil_log2(n: int) -> int:
    return (n - 1).bit_length()


# ---------------------------------------------------------------- parsers


@dataclass
class ParsedSps:
    width: int = 0
    height: int = 0
    conf_win: tuple = (0, 0, 0, 0)
    bit_depth: int = 8
    bit_depth_chroma: int = 8
    chroma_format_idc: int = 1
    log2_max_poc_lsb: int = 8
    min_cb_log2: int = 4
    ctb_log2: int = 4
    min_tb_log2: int = 2
    max_tb_log2: int = 4
    max_td_inter: int = 0
    max_td_intra: int = 0
    scaling_list_enabled: bool = False
    scaling_lists: object = None  # ScalingLists when enabled (default/explicit)
    amp_enabled: bool = False
    sao_enabled: bool = False
    pcm_enabled: bool = False
    pcm_bit_depth: int = 8
    pcm_bit_depth_chroma: int = 8
    pcm_min_log2: int = 3
    pcm_max_log2: int = 3
    pcm_loop_filter_disabled: bool = False
    num_st_rps: int = 0
    st_rps: list = field(default_factory=list)
    long_term_ref_pics: bool = False
    lt_poc_lsb_sps: list = field(default_factory=list)
    lt_used_sps: list = field(default_factory=list)
    temporal_mvp: bool = False
    strong_intra_smoothing: bool = False


def parse_sps(rbsp: bytes) -> ParsedSps:
    r = BitReader(rbsp)
    s = ParsedSps()
    r.u(4)  # sps_video_parameter_set_id
    max_sub_layers_minus1 = r.u(3)
    r.flag()  # temporal_id_nesting
    _parse_profile_tier_level(r, max_sub_layers_minus1)
    r.ue()  # sps id
    s.chroma_format_idc = r.ue()
    if s.chroma_format_idc == 3:
        r.flag()
    s.width = r.ue()
    s.height = r.ue()
    if r.flag():  # conformance window
        s.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
    s.bit_depth = 8 + r.ue()
    s.bit_depth_chroma = 8 + r.ue()
    s.log2_max_poc_lsb = 4 + r.ue()
    sub_layer_ordering = r.flag()
    for _ in range((max_sub_layers_minus1 + 1) if sub_layer_ordering else 1):
        r.ue()
        r.ue()
        r.ue()
    s.min_cb_log2 = 3 + r.ue()
    s.ctb_log2 = s.min_cb_log2 + r.ue()
    s.min_tb_log2 = 2 + r.ue()
    s.max_tb_log2 = s.min_tb_log2 + r.ue()
    s.max_td_inter = r.ue()
    s.max_td_intra = r.ue()
    s.scaling_list_enabled = bool(r.flag())
    if s.scaling_list_enabled:
        from .scaling import ScalingLists, parse_scaling_list_data

        if r.flag():  # sps_scaling_list_data_present_flag
            s.scaling_lists = parse_scaling_list_data(r)
        else:
            s.scaling_lists = ScalingLists()  # default lists (7.4.5)
    s.amp_enabled = bool(r.flag())
    s.sao_enabled = bool(r.flag())
    s.pcm_enabled = bool(r.flag())
    if s.pcm_enabled:
        s.pcm_bit_depth = r.u(4) + 1
        s.pcm_bit_depth_chroma = r.u(4) + 1
        s.pcm_min_log2 = 3 + r.ue()
        s.pcm_max_log2 = s.pcm_min_log2 + r.ue()
        s.pcm_loop_filter_disabled = bool(r.flag())
    s.num_st_rps = r.ue()
    prev = None
    for i in range(s.num_st_rps):
        prev = _parse_st_rps(r, i, s.num_st_rps, prev, s.st_rps)
    s.long_term_ref_pics = bool(r.flag())
    if s.long_term_ref_pics:
        for _ in range(r.ue()):  # num_long_term_ref_pics_sps
            s.lt_poc_lsb_sps.append(r.u(s.log2_max_poc_lsb))
            s.lt_used_sps.append(bool(r.flag()))
    s.temporal_mvp = bool(r.flag())
    s.strong_intra_smoothing = bool(r.flag())
    return s


def _parse_st_rps(r: BitReader, idx: int, num: int, prev, out: list):
    """Parse one short_term_ref_pic_set; returns (neg_deltas, pos_deltas, used)."""
    inter_rps = False
    if idx != 0:
        inter_rps = bool(r.flag())
    if inter_rps:
        delta_rps_sign = r.flag()
        abs_delta_rps = r.ue() + 1
        delta_rps = (1 - 2 * delta_rps_sign) * abs_delta_rps
        ref_neg, ref_pos, ref_used = prev
        ref_all = ref_neg + ref_pos
        num_delta_pocs = len(ref_all)
        used = []
        new_deltas = []
        for j in range(num_delta_pocs + 1):
            used_by = r.flag()
            use_delta = 1
            if not used_by:
                use_delta = r.flag()
            if j < num_delta_pocs:
                d = ref_all[j] + delta_rps
            else:
                d = delta_rps
            if used_by or use_delta:
                new_deltas.append((d, used_by))
        neg = sorted([x for x in new_deltas if x[0] < 0], key=lambda t: -t[0])
        pos = sorted([x for x in new_deltas if x[0] > 0], key=lambda t: t[0])
        res = ([d for d, _ in neg], [d for d, _ in pos], [u for _, u in neg] + [u for _, u in pos])
    else:
        nneg = r.ue()
        npos = r.ue()
        negs, poss, used = [], [], []
        acc = 0
        for _ in range(nneg):
            acc -= r.ue() + 1
            negs.append(acc)
            used.append(r.flag())
        acc = 0
        for _ in range(npos):
            acc += r.ue() + 1
            poss.append(acc)
            used.append(r.flag())
        res = (negs, poss, used)
    out.append(res)
    return res


@dataclass
class ParsedPps:
    init_qp: int = 26
    sign_data_hiding: bool = False
    cabac_init_present: bool = False
    num_ref_l0: int = 1
    num_ref_l1: int = 1
    constrained_intra: bool = False
    transform_skip: bool = False
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets: bool = False
    weighted_pred: bool = False
    weighted_bipred: bool = False
    transquant_bypass: bool = False
    tiles_enabled: bool = False
    entropy_sync: bool = False
    loop_filter_across_slices: bool = True
    deblocking_override_enabled: bool = False
    deblocking_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    log2_parallel_merge_level: int = 2
    tile_cols: list = field(default_factory=list)
    tile_rows: list = field(default_factory=list)
    uniform_spacing: bool = True
    num_tile_cols: int = 1
    num_tile_rows: int = 1
    scaling_lists: object = None  # PPS-level override of the SPS lists
    lists_modification: bool = False
    dependent_slices: bool = False


def parse_pps(rbsp: bytes) -> ParsedPps:
    r = BitReader(rbsp)
    p = ParsedPps()
    r.ue()  # pps id
    r.ue()  # sps id
    p.dependent_slices = bool(r.flag())
    r.flag()  # output_flag_present
    r.u(3)  # num_extra_slice_header_bits
    p.sign_data_hiding = bool(r.flag())
    p.cabac_init_present = bool(r.flag())
    p.num_ref_l0 = r.ue() + 1
    p.num_ref_l1 = r.ue() + 1
    p.init_qp = 26 + r.se()
    p.constrained_intra = bool(r.flag())
    p.transform_skip = bool(r.flag())
    p.cu_qp_delta_enabled = bool(r.flag())
    if p.cu_qp_delta_enabled:
        p.diff_cu_qp_delta_depth = r.ue()
    p.cb_qp_offset = r.se()
    p.cr_qp_offset = r.se()
    p.slice_chroma_qp_offsets = bool(r.flag())
    p.weighted_pred = bool(r.flag())
    p.weighted_bipred = bool(r.flag())
    p.transquant_bypass = bool(r.flag())
    p.tiles_enabled = bool(r.flag())
    p.entropy_sync = bool(r.flag())
    if p.tiles_enabled:
        p.num_tile_cols = r.ue() + 1
        p.num_tile_rows = r.ue() + 1
        p.uniform_spacing = bool(r.flag())
        if not p.uniform_spacing:
            p.tile_cols = [r.ue() + 1 for _ in range(p.num_tile_cols - 1)]
            p.tile_rows = [r.ue() + 1 for _ in range(p.num_tile_rows - 1)]
        p.loop_filter_across_tiles = bool(r.flag())
    p.loop_filter_across_slices = bool(r.flag())
    if r.flag():  # deblocking_filter_control_present_flag
        p.deblocking_override_enabled = bool(r.flag())
        p.deblocking_disabled = bool(r.flag())
        if not p.deblocking_disabled:
            p.beta_offset_div2 = r.se()
            p.tc_offset_div2 = r.se()
    if r.flag():  # pps_scaling_list_data_present_flag
        from .scaling import parse_scaling_list_data

        p.scaling_lists = parse_scaling_list_data(r)
    p.lists_modification = bool(r.flag())
    p.log2_parallel_merge_level = 2 + r.ue()
    r.flag()  # slice_segment_header_extension
    return p


@dataclass
class ParsedSliceHeader:
    first_slice: bool = True
    nal_type: int = NalType.IDR_W_RADL
    slice_type: int = 2
    segment_address: int = 0
    pic_order_cnt_lsb: int = 0
    qp: int = 26
    sao_luma: bool = False
    sao_chroma: bool = False
    num_ref_idx_l0: int = 1
    num_ref_idx_l1: int = 1
    rps: tuple = ((), (), ())
    temporal_mvp: bool = False
    collocated_from_l0: bool = True
    max_num_merge_cand: int = 5
    deblocking_disabled: bool = False
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    entry_points: list = field(default_factory=list)
    weights: dict | None = None  # pred_weight_table (7.3.6.3), parsed
    mvd_l1_zero: bool = False
    collocated_ref_idx: int = 0
    data_offset_bits: int = 0  # bit offset of slice data within RBSP
    dependent: bool = False  # dependent slice segment (inherited fields)
    cabac_init_flag: bool = False  # swaps P/B ctx init tables (9.3.2.2)
    lt_pics: list = field(default_factory=list)  # (poc_lsb, used, msb_present, msb_cycle)
    list_entry_l0: list | None = None  # ref_pic_list_modification (7.3.6.2)
    list_entry_l1: list | None = None
    cb_qp_offset: int = 0  # slice_cb_qp_offset (added to pps_cb_qp_offset)
    cr_qp_offset: int = 0
    loop_filter_across_slices: bool = True  # slice-level flag (7.4.7.1)
    poc: int = 0  # full PicOrderCntVal (8.3.1), filled by the decoder


def num_pic_total_curr(sh) -> int:
    """NumPicTotalCurr (7.4.7.1): used-by-current st + lt reference pics."""
    _negs, _poss, used = sh.rps
    n = sum(1 for u in used if u)
    n += sum(1 for (_lsb, u, _mp, _cy) in sh.lt_pics if u)
    return n


def _parse_pred_weight_table(r: BitReader, sh) -> dict:
    """pred_weight_table (7.3.6.3), L0 and (for B slices) L1.

    Returns dict(luma_denom, chroma_denom, luma/chroma per list) with the
    spec weight/offset derivation applied."""
    ld = r.ue()  # luma_log2_weight_denom
    cd = ld + r.se()  # + delta_chroma_log2_weight_denom

    def one_list(nref):
        lflags = [r.flag() for _ in range(nref)]
        cflags = [r.flag() for _ in range(nref)]
        luma = []
        chroma = []
        for i in range(nref):
            if lflags[i]:
                w = (1 << ld) + r.se()
                o = r.se()
            else:
                w, o = 1 << ld, 0
            luma.append((w, o))
            if cflags[i]:
                pair = []
                for _ in range(2):
                    cw = (1 << cd) + r.se()
                    doff = r.se()
                    co = max(-128, min(127, doff - (((128 * cw) >> cd) - 128)))
                    pair.append((cw, co))
                chroma.append(tuple(pair))
            else:
                chroma.append((((1 << cd), 0), ((1 << cd), 0)))
        return luma, chroma

    luma, chroma = one_list(sh.num_ref_idx_l0)
    out = {"luma_denom": ld, "chroma_denom": cd, "luma": luma, "chroma": chroma}
    if sh.slice_type == 0:
        luma1, chroma1 = one_list(sh.num_ref_idx_l1)
        out["luma1"] = luma1
        out["chroma1"] = chroma1
    return out


def parse_slice_header(rbsp: bytes, nal_type: int, sps: ParsedSps, pps: ParsedPps,
                       prev_independent: "ParsedSliceHeader | None" = None) -> ParsedSliceHeader:
    from .nal import is_idr, is_irap

    r = BitReader(rbsp)
    sh = ParsedSliceHeader(nal_type=nal_type)
    sh.deblocking_disabled = pps.deblocking_disabled
    sh.beta_offset_div2 = pps.beta_offset_div2
    sh.tc_offset_div2 = pps.tc_offset_div2
    sh.first_slice = bool(r.flag())
    if is_irap(nal_type):
        r.flag()  # no_output_of_prior_pics_flag
    r.ue()  # slice_pic_parameter_set_id
    if not sh.first_slice:
        dependent = pps.dependent_slices and bool(r.flag())
        ctbs = -(-sps.width // (1 << sps.ctb_log2)) * -(-sps.height // (1 << sps.ctb_log2))
        sh.segment_address = r.u(_ceil_log2(ctbs))
        if dependent:
            # 7.3.6.1: all remaining fields inherited from the preceding
            # independent slice segment's header
            if prev_independent is None:
                raise ValueError("dependent slice segment without a parent")
            from dataclasses import replace as _dc_replace

            sh = _dc_replace(prev_independent, first_slice=False, dependent=True,
                             segment_address=sh.segment_address, entry_points=[])
            if pps.tiles_enabled or pps.entropy_sync:
                n_entry = r.ue()
                if n_entry:
                    offset_len = r.ue() + 1
                    sh.entry_points = [r.u(offset_len) + 1 for _ in range(n_entry)]
            r.byte_alignment()
            sh.data_offset_bits = r.bit_pos()
            return sh
    sh.slice_type = r.ue()
    sh.num_ref_idx_l0 = pps.num_ref_l0
    sh.num_ref_idx_l1 = pps.num_ref_l1
    if not is_idr(nal_type):
        sh.pic_order_cnt_lsb = r.u(sps.log2_max_poc_lsb)
        if r.flag():  # short_term_ref_pic_set_sps_flag
            idx = r.u(_ceil_log2(sps.num_st_rps)) if sps.num_st_rps > 1 else 0
            sh.rps = sps.st_rps[idx]
        else:
            tmp: list = []
            prev = sps.st_rps[-1] if sps.st_rps else None
            sh.rps = _parse_st_rps(r, sps.num_st_rps, sps.num_st_rps + 1, prev, tmp)
        if sps.long_term_ref_pics:
            n_sps_lt = len(sps.lt_poc_lsb_sps)
            num_lt_sps = r.ue() if n_sps_lt > 0 else 0
            num_lt_pics = r.ue()
            prev_cycle = 0
            for i in range(num_lt_sps + num_lt_pics):
                if i < num_lt_sps:
                    idx = r.u(_ceil_log2(n_sps_lt)) if n_sps_lt > 1 else 0
                    lsb, used = sps.lt_poc_lsb_sps[idx], sps.lt_used_sps[idx]
                else:
                    lsb = r.u(sps.log2_max_poc_lsb)
                    used = bool(r.flag())
                msb_present = bool(r.flag())
                cycle = 0
                if msb_present:
                    cycle = r.ue()
                    if i not in (0, num_lt_sps):  # 7.4.7.1: cycles accumulate
                        cycle += prev_cycle
                    prev_cycle = cycle
                sh.lt_pics.append((lsb, used, msb_present, cycle))
        if sps.temporal_mvp:
            sh.temporal_mvp = bool(r.flag())
    if sps.sao_enabled:
        sh.sao_luma = bool(r.flag())
        sh.sao_chroma = bool(r.flag())
    if sh.slice_type != 2:
        if r.flag():  # num_ref_idx_active_override
            sh.num_ref_idx_l0 = r.ue() + 1
            if sh.slice_type == 0:
                sh.num_ref_idx_l1 = r.ue() + 1
        # ref_pic_list_modification (7.3.6.2)
        npt = num_pic_total_curr(sh)
        if pps.lists_modification and npt > 1:
            nb = _ceil_log2(npt)
            if r.flag():  # ref_pic_list_modification_flag_l0
                sh.list_entry_l0 = [r.u(nb) for _ in range(sh.num_ref_idx_l0)]
            if sh.slice_type == 0:
                if r.flag():
                    sh.list_entry_l1 = [r.u(nb) for _ in range(sh.num_ref_idx_l1)]
        if sh.slice_type == 0:
            sh.mvd_l1_zero = bool(r.flag())
        if pps.cabac_init_present:
            sh.cabac_init_flag = bool(r.flag())
        if sh.temporal_mvp:
            if sh.slice_type == 0:
                sh.collocated_from_l0 = bool(r.flag())
            nref = sh.num_ref_idx_l0 if sh.collocated_from_l0 else sh.num_ref_idx_l1
            if nref > 1:
                sh.collocated_ref_idx = r.ue()
        if (pps.weighted_pred and sh.slice_type == 1) or (
            pps.weighted_bipred and sh.slice_type == 0
        ):
            sh.weights = _parse_pred_weight_table(r, sh)
        sh.max_num_merge_cand = 5 - r.ue()
    sh.qp = pps.init_qp + r.se()
    if pps.slice_chroma_qp_offsets:
        sh.cb_qp_offset = r.se()
        sh.cr_qp_offset = r.se()
    if pps.deblocking_override_enabled:
        if r.flag():  # deblocking_filter_override_flag
            sh.deblocking_disabled = bool(r.flag())
            if not sh.deblocking_disabled:
                sh.beta_offset_div2 = r.se()
                sh.tc_offset_div2 = r.se()
    sh.loop_filter_across_slices = pps.loop_filter_across_slices
    if pps.loop_filter_across_slices and (
        sh.sao_luma or sh.sao_chroma or not sh.deblocking_disabled
    ):
        sh.loop_filter_across_slices = bool(r.flag())
    if pps.tiles_enabled or pps.entropy_sync:
        n_entry = r.ue()
        if n_entry:
            offset_len = r.ue() + 1
            sh.entry_points = [r.u(offset_len) + 1 for _ in range(n_entry)]
    r.byte_alignment()
    sh.data_offset_bits = r.bit_pos()
    return sh
