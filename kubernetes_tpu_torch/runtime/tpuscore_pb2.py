# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tpuscore.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0etpuscore.proto\x12\x08tpuscore\"+\n\x08Quantity\x12\x10\n\x08resource\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03\"#\n\x05Label\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"3\n\x05Taint\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\x12\x0e\n\x06\x65\x66\x66\x65\x63t\x18\x03 \x01(\t\"D\n\nToleration\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\n\n\x02op\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\x12\x0e\n\x06\x65\x66\x66\x65\x63t\x18\x04 \x01(\t\"C\n\x18LabelSelectorRequirement\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\n\n\x02op\x18\x02 \x01(\t\x12\x0e\n\x06values\x18\x03 \x03(\t\"\x86\x01\n\rLabelSelector\x12\x0f\n\x07present\x18\x01 \x01(\x08\x12%\n\x0cmatch_labels\x18\x02 \x03(\x0b\x32\x0f.tpuscore.Label\x12=\n\x11match_expressions\x18\x03 \x03(\x0b\x32\".tpuscore.LabelSelectorRequirement\"Q\n\x10NodeSelectorTerm\x12=\n\x11match_expressions\x18\x01 \x03(\x0b\x32\".tpuscore.LabelSelectorRequirement\"Y\n\x17PreferredSchedulingTerm\x12\x0e\n\x06weight\x18\x01 \x01(\x05\x12.\n\npreference\x18\x02 \x01(\x0b\x32\x1a.tpuscore.NodeSelectorTerm\"f\n\x0fPodAffinityTerm\x12\x14\n\x0ctopology_key\x18\x01 \x01(\t\x12)\n\x08selector\x18\x02 \x01(\x0b\x32\x17.tpuscore.LabelSelector\x12\x12\n\nnamespaces\x18\x03 \x03(\t\"R\n\x17WeightedPodAffinityTerm\x12\x0e\n\x06weight\x18\x01 \x01(\x05\x12\'\n\x04term\x18\x02 \x01(\x0b\x32\x19.tpuscore.PodAffinityTerm\".\n\nImageEntry\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x12\n\nsize_bytes\x18\x02 \x01(\x03\"\x89\x01\n\x18TopologySpreadConstraint\x12\x10\n\x08max_skew\x18\x01 \x01(\x05\x12\x14\n\x0ctopology_key\x18\x02 \x01(\t\x12\x1a\n\x12when_unsatisfiable\x18\x03 \x01(\t\x12)\n\x08selector\x18\x04 \x01(\x0b\x32\x17.tpuscore.LabelSelector\"*\n\x08HostPort\x12\x10\n\x08protocol\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\x05\"\xbc\x01\n\x04Node\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\'\n\x0b\x61llocatable\x18\x02 \x03(\x0b\x32\x12.tpuscore.Quantity\x12\x1f\n\x06labels\x18\x03 \x03(\x0b\x32\x0f.tpuscore.Label\x12\x1f\n\x06taints\x18\x04 \x03(\x0b\x32\x0f.tpuscore.Taint\x12\x15\n\runschedulable\x18\x05 \x01(\x08\x12$\n\x06images\x18\x06 \x03(\x0b\x32\x14.tpuscore.ImageEntry\"\x92\x06\n\x03Pod\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12\x0b\n\x03uid\x18\x03 \x01(\t\x12$\n\x08requests\x18\x04 \x03(\x0b\x32\x12.tpuscore.Quantity\x12\x1f\n\x06labels\x18\x05 \x03(\x0b\x32\x0f.tpuscore.Label\x12\x11\n\tnode_name\x18\x06 \x01(\t\x12\x10\n\x08priority\x18\x07 \x01(\x05\x12)\n\x0btolerations\x18\x08 \x03(\x0b\x32\x14.tpuscore.Toleration\x12&\n\rnode_selector\x18\t \x03(\x0b\x32\x0f.tpuscore.Label\x12\x37\n\x13required_node_terms\x18\n \x03(\x0b\x32\x1a.tpuscore.NodeSelectorTerm\x12?\n\x14preferred_node_terms\x18\x0b \x03(\x0b\x32!.tpuscore.PreferredSchedulingTerm\x12\x38\n\x15required_pod_affinity\x18\x0c \x03(\x0b\x32\x19.tpuscore.PodAffinityTerm\x12=\n\x1arequired_pod_anti_affinity\x18\r \x03(\x0b\x32\x19.tpuscore.PodAffinityTerm\x12;\n\x0ftopology_spread\x18\x0e \x03(\x0b\x32\".tpuscore.TopologySpreadConstraint\x12&\n\nhost_ports\x18\x0f \x03(\x0b\x32\x12.tpuscore.HostPort\x12\x18\n\x10scheduling_gates\x18\x10 \x03(\t\x12\x11\n\tpod_group\x18\x11 \x01(\t\x12\x41\n\x16preferred_pod_affinity\x18\x12 \x03(\x0b\x32!.tpuscore.WeightedPodAffinityTerm\x12\x46\n\x1bpreferred_pod_anti_affinity\x18\x13 \x03(\x0b\x32!.tpuscore.WeightedPodAffinityTerm\x12\x0e\n\x06images\x18\x14 \x03(\t\",\n\x08PodGroup\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x12\n\nmin_member\x18\x02 \x01(\x05\"\x99\x01\n\x08Snapshot\x12\x1d\n\x05nodes\x18\x01 \x03(\x0b\x32\x0e.tpuscore.Node\x12#\n\x0cpending_pods\x18\x02 \x03(\x0b\x32\r.tpuscore.Pod\x12!\n\nbound_pods\x18\x03 \x03(\x0b\x32\r.tpuscore.Pod\x12&\n\npod_groups\x18\x04 \x03(\x0b\x32\x12.tpuscore.PodGroup\"L\n\x0cInternedWave\x12\x1c\n\x05specs\x18\x01 \x03(\x0b\x32\r.tpuscore.Pod\x12\x0c\n\x04uids\x18\x02 \x03(\t\x12\x10\n\x08spec_idx\x18\x03 \x03(\x05\"%\n\x04\x42ind\x12\x0f\n\x07pod_uid\x18\x01 \x01(\t\x12\x0c\n\x04node\x18\x02 \x01(\t\"\xb3\x01\n\x0cSessionDelta\x12\x12\n\nbase_epoch\x18\x01 \x01(\x04\x12\x1d\n\x05\x62inds\x18\x02 \x03(\x0b\x32\x0e.tpuscore.Bind\x12\x14\n\x0c\x64\x65leted_uids\x18\x03 \x03(\t\x12\"\n\x0b\x61\x64\x64\x65\x64_bound\x18\x04 \x03(\x0b\x32\r.tpuscore.Pod\x12\x1c\n\x14\x62ind_prev_assignment\x18\x05 \x01(\x08\x12\x18\n\x10\x62ind_prev_except\x18\x06 \x03(\t\"\x8e\x02\n\x0fScheduleRequest\x12$\n\x08snapshot\x18\x01 \x01(\x0b\x32\x12.tpuscore.Snapshot\x12\x13\n\x0b\x64\x65\x61\x64line_ms\x18\x02 \x01(\x01\x12\x0c\n\x04gang\x18\x03 \x01(\x08\x12%\n\x18hard_pod_affinity_weight\x18\x04 \x01(\x01H\x00\x88\x01\x01\x12\x12\n\nsession_id\x18\x05 \x01(\t\x12\r\n\x05\x65poch\x18\x06 \x01(\x04\x12%\n\x05\x64\x65lta\x18\x07 \x01(\x0b\x32\x16.tpuscore.SessionDelta\x12$\n\x04wave\x18\x08 \x01(\x0b\x32\x16.tpuscore.InternedWaveB\x1b\n\x19_hard_pod_affinity_weight\";\n\x07Verdict\x12\x0f\n\x07pod_uid\x18\x01 \x01(\t\x12\x0c\n\x04node\x18\x02 \x01(\t\x12\x11\n\tscheduled\x18\x03 \x01(\x08\"\x9a\x01\n\x10ScheduleResponse\x12#\n\x08verdicts\x18\x01 \x03(\x0b\x32\x11.tpuscore.Verdict\x12\x12\n\nelapsed_ms\x18\x02 \x01(\x01\x12\x11\n\tnot_ready\x18\x03 \x01(\x08\x12\x17\n\x0fresync_required\x18\x04 \x01(\x08\x12\r\n\x05\x65poch\x18\x05 \x01(\x04\x12\x12\n\nassignment\x18\x06 \x03(\x05\"\x0f\n\rHealthRequest\"S\n\x0eHealthResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x10\n\x08platform\x18\x02 \x01(\t\x12\x14\n\x0c\x64\x65vice_count\x18\x03 \x01(\x05\x12\r\n\x05ready\x18\x04 \x01(\x08\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tpuscore_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _QUANTITY._serialized_start=28
  _QUANTITY._serialized_end=71
  _LABEL._serialized_start=73
  _LABEL._serialized_end=108
  _TAINT._serialized_start=110
  _TAINT._serialized_end=161
  _TOLERATION._serialized_start=163
  _TOLERATION._serialized_end=231
  _LABELSELECTORREQUIREMENT._serialized_start=233
  _LABELSELECTORREQUIREMENT._serialized_end=300
  _LABELSELECTOR._serialized_start=303
  _LABELSELECTOR._serialized_end=437
  _NODESELECTORTERM._serialized_start=439
  _NODESELECTORTERM._serialized_end=520
  _PREFERREDSCHEDULINGTERM._serialized_start=522
  _PREFERREDSCHEDULINGTERM._serialized_end=611
  _PODAFFINITYTERM._serialized_start=613
  _PODAFFINITYTERM._serialized_end=715
  _WEIGHTEDPODAFFINITYTERM._serialized_start=717
  _WEIGHTEDPODAFFINITYTERM._serialized_end=799
  _IMAGEENTRY._serialized_start=801
  _IMAGEENTRY._serialized_end=847
  _TOPOLOGYSPREADCONSTRAINT._serialized_start=850
  _TOPOLOGYSPREADCONSTRAINT._serialized_end=987
  _HOSTPORT._serialized_start=989
  _HOSTPORT._serialized_end=1031
  _NODE._serialized_start=1034
  _NODE._serialized_end=1222
  _POD._serialized_start=1225
  _POD._serialized_end=2011
  _PODGROUP._serialized_start=2013
  _PODGROUP._serialized_end=2057
  _SNAPSHOT._serialized_start=2060
  _SNAPSHOT._serialized_end=2213
  _INTERNEDWAVE._serialized_start=2215
  _INTERNEDWAVE._serialized_end=2291
  _BIND._serialized_start=2293
  _BIND._serialized_end=2330
  _SESSIONDELTA._serialized_start=2333
  _SESSIONDELTA._serialized_end=2512
  _SCHEDULEREQUEST._serialized_start=2515
  _SCHEDULEREQUEST._serialized_end=2785
  _VERDICT._serialized_start=2787
  _VERDICT._serialized_end=2846
  _SCHEDULERESPONSE._serialized_start=2849
  _SCHEDULERESPONSE._serialized_end=3003
  _HEALTHREQUEST._serialized_start=3005
  _HEALTHREQUEST._serialized_end=3020
  _HEALTHRESPONSE._serialized_start=3022
  _HEALTHRESPONSE._serialized_end=3105
# @@protoc_insertion_point(module_scope)
