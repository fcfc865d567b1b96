"""Config keys and defaults: a copy of ``deepspeed_tpu/runtime/constants.py``
(the port may not import the JAX package). The JSON vocabulary accepted by
``deepspeed_tpu_torch.initialize(config=...)`` is the JAX package's.
"""

# batch arithmetic (reference runtime/constants.py TRAIN_BATCH_SIZE etc.)
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"
TYPE = "type"
PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

PRESCALE_GRADIENTS = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"

FP16 = "fp16"
BF16 = "bf16"
ENABLED = "enabled"

ZERO_OPTIMIZATION = "zero_optimization"
ZERO_STAGE = "stage"

ACTIVATION_CHECKPOINTING = "activation_checkpointing"

MESH = "mesh"  # TPU-native extension: axis sizes {pp,dp,fsdp,ep,sp,tp}

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
MEMORY_BREAKDOWN = "memory_breakdown"

SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENT_MODULES = "sparse_gradient_modules"
PIPELINE = "pipeline"
SPARSE_ATTENTION = "sparse_attention"

DATALOADER_DROP_LAST = "dataloader_drop_last"

CURRICULUM_LEARNING = "curriculum_learning"
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
EIGENVALUE = "eigenvalue"
QUANTIZE_TRAINING = "quantize_training"

TENSORBOARD = "tensorboard"
WANDB = "wandb"
CSV_MONITOR = "csv_monitor"
FLOPS_PROFILER = "flops_profiler"
ELASTICITY = "elasticity"
AUTOTUNING = "autotuning"
COMMUNICATION_DATA_TYPE = "communication_data_type"
SEED = "seed"

# optimizer names (reference runtime/config.py:82-120 optimizer dispatch)
ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
LION_OPTIMIZER = "lion"
ADAM8BIT_OPTIMIZER = "adam8bit"
ADAMW8BIT_OPTIMIZER = "adamw8bit"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
DEEPSPEED_OPTIMIZERS = [
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, SGD_OPTIMIZER,
    ADAGRAD_OPTIMIZER, LION_OPTIMIZER, ADAM8BIT_OPTIMIZER,
    ADAMW8BIT_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
    ONEBIT_LAMB_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER,
]
