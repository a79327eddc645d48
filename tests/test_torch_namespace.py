"""The port's namespace against the JAX package's (the pattern of
tests/test_namespace_parity.py): every public name of each JAX module
below resolves in the port's counterpart, or stands in EXPECTED_ABSENT
with the ROADMAP queue 1 item that will port it, or with why it is not
paddle API. A name listed as absent that resolves fails the test too, so
the list shrinks as the port grows and queue 1's size is this file's
output. JAX modules with no port counterpart are listed whole in
ABSENT_MODULES."""
import ast
import importlib
import types

import pytest

pytest.importorskip("torch")

import paddle_tpu  # noqa: E402,F401
import paddle_tpu_torch  # noqa: E402,F401

ITEM8_PREDICTOR = ("queue 1 item 8: the predictor API, the one-shot "
                   "DynamicBatcher and the server's predictor mode")
ITEM7 = "queue 1 item 7: multi-GPU over NCCL"
ITEM8 = "queue 1 item 8: export and static graph"
ITEM9 = "queue 1 item 9: nn breadth"
ITEM10 = "queue 1 item 10: long tail (legacy shims, io/fs, dataset, text)"
IMPL = "not paddle API: an implementation import of the JAX module"


def _group(reason, names):
    return {n: reason for n in names.split()}


EXPECTED_ABSENT = {
    "": {
        **_group(ITEM8, "jit onnx data"),
        **_group(ITEM10, """
            legacy_alias create_global_var create_parameter crop_tensor
            disable_dygraph disable_static enable_dygraph enable_static
            in_dygraph_mode in_dynamic_mode elementwise_add elementwise_div
            elementwise_floordiv elementwise_max elementwise_min
            elementwise_mod elementwise_mul elementwise_pow elementwise_sub
            fill_constant get_cudnn_version get_tensor_from_selected_rows
            has_inf has_nan is_compiled_with_xpu monkey_patch_math_varbase
            monkey_patch_variable reduce_all reduce_any reduce_max
            reduce_mean reduce_min reduce_prod reduce_sum shape shard_index
            dataset distribution incubate text"""),
        **_group("not paddle API: the JAX tape's op dispatcher", "apply"),
    },
    "nn": {
        **_group(ITEM7, "MoELayer"),
        **_group(ITEM8, "cond while_loop Input"),
        **_group(ITEM9, """
            AdaptiveAvgPool1D AdaptiveAvgPool3D AdaptiveMaxPool1D
            AdaptiveMaxPool2D AdaptiveMaxPool3D AlphaDropout AvgPool1D
            AvgPool3D BCELoss BCEWithLogitsLoss BatchNorm1D BatchNorm3D
            BeamSearchDecoder BiRNN Bilinear CELU CTCLoss ChannelShuffle
            Conv1D Conv1DTranspose Conv2DTranspose Conv3D Conv3DTranspose
            CosineEmbeddingLoss CosineSimilarity Decoder Dropout2D Dropout3D
            DynamicRNN ELU Fold GELU GLU GRU GRUCell GroupNorm HSigmoidLoss
            Hardshrink Hardsigmoid Hardswish Hardtanh HingeEmbeddingLoss
            Identity InstanceNorm1D InstanceNorm2D InstanceNorm3D KLDivLoss
            L1Loss LSTM LSTMCell LayerDict LeakyReLU LocalResponseNorm
            LogSigmoid LogSoftmax MSELoss MarginRankingLoss MaxPool1D
            MaxPool3D Maxout Mish NCELoss NLLLoss PReLU Pad1D Pad2D Pad3D
            PairwiseDistance ParameterList PixelShuffle PixelUnshuffle
            RMSNorm RNN RNNCellBase RReLU ReLU6 SELU ScanBlockStack Sigmoid
            Silu SimpleRNN SimpleRNNCell SmoothL1Loss SoftMarginLoss Softmax
            Softplus Softshrink Softsign SpectralNorm StaticRNN Swish
            SyncBatchNorm Tanh Tanhshrink ThresholdedReLU TreeConv
            TripletMarginLoss Unfold Upsample UpsamplingBilinear2D
            UpsamplingNearest2D ZeroPad2D common conv crf_decoding
            ctc_greedy_decoder dynamic_decode extension gather_tree
            initializer_setup loss norm remove_weight_norm rnn utils
            vision weight_norm weight_norm_hook"""),
    },
    "nn.functional": {
        **_group(ITEM9, """
            adaptive_avg_pool1d adaptive_avg_pool3d adaptive_max_pool1d
            adaptive_max_pool2d adaptive_max_pool3d add_position_encoding
            affine_channel affine_grid alpha_dropout anchor_generator
            array_length array_ops array_read array_write
            autoincreased_step_counter avg_pool1d avg_pool3d bilinear
            bilinear_tensor_product binary_cross_entropy
            binary_cross_entropy_with_logits bipartite_match birnn box_clip
            box_coder box_decoder_and_assign bpr_loss center_loss
            channel_shuffle class_center_sample collect_fpn_proposals
            continuous_value_model conv1d conv1d_transpose
            conv2d_transpose conv3d conv3d_transpose cosine_embedding_loss
            cosine_similarity create_array crf_decoding ctc_loss data_norm
            deformable_conv deformable_roi_pooling density_prior_box
            detection detection_output detection_tail diag_embed dice_loss
            distribute_fpn_proposals dropout2d dropout3d dynamic_gru
            dynamic_lstm dynamic_lstmp elu_ extension fc filter_by_instag fold
            fsp_matrix gather_tree generate_mask_labels
            generate_proposal_labels generate_proposals grid_sample
            grid_sampler group_norm gru_unit hash hinge_embedding_loss
            hsigmoid_loss im2sequence image_resize image_resize_short
            instance_norm interpolate iou_similarity kl_div l1_loss
            label_smooth linear_chain_crf local_response_norm
            locality_aware_nms lod_append lod_reset log_loss lstm lstm_unit
            margin_ranking_loss matrix_nms max_pool1d max_pool3d maxout
            merge_selected_rows mse_loss multi_box_head multiclass_nms
            multiclass_nms_static nce nll_loss normalize npair_loss one_hot
            pad2d pad_constant_like pixel_shuffle pixel_unshuffle
            polygon_box_transform pool2d pool3d prelu prior_box
            prroi_pool psroi_pool random_crop relu_ reorder_lod_tensor_by_rank
            resize_bilinear resize_nearest resize_trilinear
            retinanet_detection_output retinanet_target_assign rnn rnn_legacy
            roi_align roi_perspective_transform roi_pool rpn_target_assign
            sequence sequence_concat sequence_conv sequence_enumerate
            sequence_expand sequence_expand_as sequence_first_step
            sequence_last_step sequence_mask sequence_pad sequence_pool
            sequence_reshape sequence_reverse sequence_scatter sequence_slice
            sequence_softmax sequence_unpad shuffle_channel
            sigmoid_focal_loss similarity_focus smooth_l1 smooth_l1_loss
            soft_margin_loss soft_relu softmax_ space_to_depth spectral_norm
            square_error_cost tanh_ target_assign
            teacher_student_sigmoid_loss temporal_shift
            tensor_array_to_tensor triplet_margin_loss unfold upsample vision
            warpctc yolo_box yolov3_loss"""),
    },
    "io": _group(ITEM10, "FS LocalFS fs sync_dir InMemoryDataset Slot "
                 "data_feed"),
    "optimizer": {},
    "amp": {
        **_group(IMPL, "Dict Tensor dtype_mod jax jnp no_grad np"),
    },
    "metric": _group(IMPL, "Tensor"),
    "static": {
        **_group(ITEM8, """
            BuildStrategy CompiledProgram ExecutionStrategy Executor
            ParallelExecutor Print Program Scope Variable WeightNormParamAttr
            accuracy amp append_backward auc compat cpu_places
            create_global_var create_parameter cuda_places data
            default_main_program default_startup_program
            deserialize_persistables deserialize_program device_guard
            global_scope gradients load load_from_file load_inference_model
            load_program_state load_vars name_scope nn
            normalize_program program_guard py_func save save_inference_model
            save_to_file save_vars scope_guard serialize_persistables
            serialize_program set_program_state xpu_places"""),
        **_group(IMPL, "dtype_mod"),
    },
    "distributed": {
        **_group(ITEM7, """
            CountFilterEntry EntryAttr FileStore PipelineLayer
            ProbabilityEntry ReduceOp Store TCPStore all_gather all_reduce
            alltoall broadcast cloud_utils collective elastic entry_attr
            get_group named_sharding new_group p2p pipeline pipeline_spmd
            recv reduce reduce_scatter scatter send sequence_parallel
            sharding spawn stack_stage_params store"""),
        **_group(ITEM10, "InMemoryDataset QueueDataset"),
    },
    "distributed.fleet": {
        **_group(ITEM7, "data_generator dataset metrics"),
        **_group(IMPL, "jax"),
    },
    "observability": {},
    "nn.initializer": {
        **_group(ITEM9, """
            Assign Bilinear Dirac Initializer KaimingNormal KaimingUniform
            Orthogonal TruncatedNormal Uniform XavierUniform assign
            calculate_gain constant kaiming normal set_global_initializer
            uniform xavier"""),
        **_group(IMPL, "Tensor dtype_mod jax jnp np random_mod"),
    },
    "utils": {
        **_group(ITEM10, """
            OpLastCheckpointChecker collective_bench compat cpp_extension
            custom_op deprecated download dump_config op_bench register_op
            require_version retry run_check try_import unique_name"""),
    },
    "quant": {
        **_group(ITEM10, """
            Int8Linear PTQ QAT QATLinear fake_quant_abs_max quanted_layers"""),
        **_group(IMPL, "F Tensor annotations apply jax jnp nn np"),
        **_group("not paddle API: a JAX ShapeDtypeStruct for AOT tracing",
                 "kv_pool_sds"),
    },
    "memory": {},
    "memory.migration": {},
    "testing": {},
    "testing.chaos": {},
    "device": {
        **_group(ITEM10, """
            CPUPlace Place TPUPlace device_count get_all_device_type
            is_compiled_with_cuda is_compiled_with_tpu synchronize"""),
        **_group(IMPL, "annotations jax"),
    },
    "vision": _group(ITEM9, "ops"),
    "vision.models": _group(ITEM9, """
        VGG vgg vgg11 vgg13 vgg16 vgg19 MobileNetV1 MobileNetV2 mobilenet
        mobilenet_v1 mobilenet_v2 mobilenetv1 mobilenetv2"""),
    "inference": {
        **_group(ITEM8_PREDICTOR, """
            Config DataType PlaceType PrecisionType Predictor PredictorPool
            create_predictor get_num_bytes_of_data_type get_version"""),
        **_group(IMPL, "Tensor annotations jit_mod np"),
    },
    "inference.batching": {
        **_group(ITEM8_PREDICTOR,
                 "DynamicBatcher DEFAULT_MAX_BATCH DEFAULT_TIMEOUT_MS"),
        **_group(IMPL, """
            Dict ERR_RESOURCE_EXHAUSTED ERR_UNAVAILABLE Future
            InvalidStateError Queue TypedServeError chaos deque np product
            threading time"""),
    },
    "inference.decode": {
        **_group(ITEM8, "AotCache"),
        **_group(IMPL, "jax jnp quantize_kv"),
        **_group("not paddle API: a JAX ShapeDtypeStruct for AOT tracing",
                 "kv_pool_sds"),
    },
}

ABSENT_MODULES = {
    "jit": ITEM8,
    "text": ITEM10,
    "distribution": ITEM10,
    "incubate": ITEM10,
    "static.nn": ITEM8,
}


def _bound_at_import(mod):
    """Names a module's own source binds when it is imported: its defs,
    assignments and imports (a relative `from .x import ...` binds the
    submodule x too). A submodule that some other code imported later
    is an attribute as well, but only in that process: it is not
    counted, so the walk does not depend on what ran before it."""
    with open(mod.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
            if node.level and node.module:
                names.add(node.module.split(".")[0])
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
    return names


def _public(mod):
    bound = _bound_at_import(mod)
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and (not isinstance(getattr(mod, n), types.ModuleType)
                       or n in bound))


@pytest.mark.parametrize("name", sorted(EXPECTED_ABSENT),
                         ids=[n or "top" for n in sorted(EXPECTED_ABSENT)])
def test_every_jax_name_resolves_or_is_listed(name):
    jmod = importlib.import_module("paddle_tpu" + ("." + name if name
                                                   else ""))
    tmod = importlib.import_module("paddle_tpu_torch" + ("." + name if name
                                                         else ""))
    absent = EXPECTED_ABSENT[name]
    jnames, tnames = set(_public(jmod)), set(_public(tmod))
    missing = sorted(jnames - tnames - set(absent))
    assert not missing, f"{name or 'top'}: unported and unlisted {missing}"
    resolved = sorted(set(absent) & tnames)
    assert not resolved, \
        f"{name or 'top'}: listed as absent but present {resolved}"
    stale = sorted(set(absent) - jnames)
    assert not stale, f"{name or 'top'}: not a JAX name {stale}"


@pytest.mark.parametrize("name", sorted(ABSENT_MODULES))
def test_absent_modules_are_absent(name):
    importlib.import_module("paddle_tpu." + name)
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module("paddle_tpu_torch." + name)


def test_each_entry_names_its_queue_item_and_counts_the_queue(capsys):
    """Every absent name gives a queue 1 item or says why it is not
    paddle API. Prints queue 1's size by module (run with -s)."""
    for mod, d in EXPECTED_ABSENT.items():
        for n, reason in d.items():
            assert reason.startswith(("queue 1 item", "not paddle API")), \
                (mod, n, reason)
    todo = {m or "top": sum(1 for r in d.values()
                            if not r.startswith("not paddle API"))
            for m, d in EXPECTED_ABSENT.items()}
    with capsys.disabled():
        print(f"\nport namespace: names still to port {todo}, "
              f"{sum(todo.values())} in all; whole modules "
              f"{sorted(ABSENT_MODULES)}")
