// K8's assembly at wide shapes: csrc/id.cu compiled again over
// csrc/stage_wide.cuh (32 joints, 8 feet of force size 3 or 6: Talos's two
// 6D quad feet), in the namespace smpc_wide, with its C entry points
// renamed smpc_wide_id_assemble_*.  The force size comes from Dims here
// (SMPC_ID_FS), where id.cu fixes it at 3; with 6D contacts the feet's
// Jacobian rows are LOCAL_WORLD_ALIGNED [lin; ang] and their J-dot v
// [a_lin + a_ang x p + w x p-dot; a_ang] (id.cu `lwa_rows`), the cone
// rows are the 17-row wrench cone of each foot (ocp/cones.py
// `wrench_cone_mat`, packed by kernels.py `_id_params`), and the
// force-regularization, motion, inactive-force and normal-force rows run
// at the 6-row stride.  stage_wide.cuh includes stage.cuh first at the
// wide limits, so the includes of id.cu and fulldyn.cuh find it done
// (#pragma once) and their `namespace smpc` opens smpc_wide.
#include "stage_wide.cuh"

#define smpc smpc_wide
#define SMPC_ID_FS (D.fs)
#define smpc_id_assemble_f32 smpc_wide_id_assemble_f32
#define smpc_id_assemble_f64 smpc_wide_id_assemble_f64
#include "id.cu"
